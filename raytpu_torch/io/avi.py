"""AVI video muxer — replaces the reference's avifil32.dll P/Invoke layer
(the port's own copy of ``raytpu/io/avi.py``).

The reference's only native boundary is the third-party AviFile wrapper
(aviFileWrapper_src/Avi.cs:175-389, ~25 ``DllImport("avifil32.dll")`` entry
points) used by ``Game1.compileVideo`` to stitch per-frame bitmaps into an
AVI at 30 fps (Game1.cs:192-210, VideoStream.AddFrame,
VideoStream.cs:344-365).  avifil32 is Windows-only; this module writes the
RIFF/AVI container directly, with two codecs:

- ``"MJPG"`` (default): frames JPEG-encoded by Pillow (PIL), imported at
  use — small files, playable everywhere.
- ``"DIB "``: uncompressed bottom-up BGR24, bit-equivalent to what
  ``AVIStreamWrite`` received from the locked bitmaps.

A C++ implementation of the same muxer lives in ``native/avimux.cc``; the
port builds it with ``g++`` into ``build/raytpu_torch/`` at first use
(never inside ``native/``) and loads it with ctypes.  The pure-Python
writer is the fallback and the semantic reference: both write the same
bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import io as _io
import os
import struct
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from raytpu_torch.io.image import to_uint8

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "avimux.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raytpu_torch"


def _fourcc(s: str) -> bytes:
    return s.encode("ascii")


def _jpeg(arr: np.ndarray, quality: int) -> bytes:
    """One JPEG-encoded frame (the "MJPG" codec needs Pillow)."""
    from raytpu_torch.io.image import pil_image

    buf = _io.BytesIO()
    pil_image().fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class AviWriter:
    """Streaming AVI writer (AviManager + VideoStream analog).

    Usage::

        with AviWriter(path, fps=30) as w:
            for frame in frames:          # (H, W, 3) uint8 RGB
                w.add_frame(frame)
    """

    def __init__(self, path: str, fps: float = 30.0, codec: str = "MJPG",
                 quality: int = 90):
        if codec not in ("MJPG", "DIB "):
            raise ValueError(f"unsupported codec {codec!r}")
        self.path = path
        self.fps = fps
        self.codec = codec
        self.quality = quality
        self._frames: List[bytes] = []
        self._wh: Optional[tuple] = None

    # -- frame ingestion ----------------------------------------------------
    def add_frame(self, frame) -> None:
        """Append an (H, W, 3) RGB frame (uint8 or float [0, 1]; a tensor
        on any device, or an array)."""
        arr = to_uint8(frame)
        if arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3), got {arr.shape}")
        h, w = arr.shape[:2]
        if self._wh is None:
            self._wh = (w, h)
        elif self._wh != (w, h):
            raise ValueError("frame size changed mid-stream")
        if self.codec == "MJPG":
            self._frames.append(_jpeg(arr, self.quality))
        else:
            # Bottom-up BGR24 rows padded to 4 bytes (the DIB layout
            # VideoStream.AddFrame fed to AVIStreamWrite).
            bgr = arr[::-1, :, ::-1]
            stride = (w * 3 + 3) & ~3
            if stride != w * 3:
                padded = np.zeros((h, stride), np.uint8)
                padded[:, : w * 3] = bgr.reshape(h, -1)
                self._frames.append(padded.tobytes())
            else:
                self._frames.append(bgr.tobytes())

    # -- container ----------------------------------------------------------
    def close(self) -> None:
        if self._wh is None:
            raise ValueError("no frames written")
        w, h = self._wh
        n = len(self._frames)
        rate = int(round(self.fps * 1000))
        scale = 1000
        uncompressed = self.codec == "DIB "
        frame_size = ((w * 3 + 3) & ~3) * h if uncompressed else max(
            len(f) for f in self._frames
        )

        # avih: MainAVIHeader (AVIFILEINFO analog, Avi.cs:120-139).
        avih = struct.pack(
            "<14I",
            int(1_000_000 / self.fps),  # dwMicroSecPerFrame
            frame_size * int(self.fps),  # dwMaxBytesPerSec
            0,  # dwPaddingGranularity
            0x10,  # dwFlags: AVIF_HASINDEX
            n,  # dwTotalFrames
            0,  # dwInitialFrames
            1,  # dwStreams
            frame_size,  # dwSuggestedBufferSize
            w, h, 0, 0, 0, 0,
        )
        # strh: AVISTREAMINFO analog (Avi.cs:76-96).
        strh = struct.pack(
            "<4s4sIHHIIIIIIII4i",
            _fourcc("vids"), _fourcc(self.codec), 0, 0, 0, 0,
            scale, rate, 0, n, frame_size, 0xFFFFFFFF, 0,
            0, 0, w, h,
        )
        # strf: BITMAPINFOHEADER (Avi.cs:50-62).
        compression = 0 if uncompressed else struct.unpack("<I", _fourcc("MJPG"))[0]
        strf = struct.pack(
            "<IiiHHIIiiII",
            40, w, h, 1, 24, compression, frame_size, 0, 0, 0, 0,
        )

        def chunk(cc, payload):
            pad = b"\x00" if len(payload) % 2 else b""
            return _fourcc(cc) + struct.pack("<I", len(payload)) + payload + pad

        def lst(cc, payload):
            body = _fourcc(cc) + payload
            return _fourcc("LIST") + struct.pack("<I", len(body)) + body

        strl = lst("strl", chunk("strh", strh) + chunk("strf", strf))
        hdrl = lst("hdrl", chunk("avih", avih) + strl)

        # movi chunks + idx1 index (AVIF_HASINDEX).
        movi_body = b""
        index = b""
        offset = 4  # offsets are relative to the start of 'movi'
        cc = "00db" if uncompressed else "00dc"
        for f in self._frames:
            c = chunk(cc, f)
            index += _fourcc(cc) + struct.pack("<III", 0x10, offset, len(f))
            movi_body += c
            offset += len(c)
        movi = lst("movi", movi_body)
        idx1 = chunk("idx1", index)

        riff_body = _fourcc("AVI ") + hdrl + movi + idx1
        with open(self.path, "wb") as fh:
            fh.write(_fourcc("RIFF") + struct.pack("<I", len(riff_body)) + riff_body)
        self._frames = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None and self._wh is not None:
            self.close()


_NATIVE = {}


def _native_lib():
    """native/avimux.cc built with ``g++`` into ``build/raytpu_torch/``
    (named by a hash of the source) and loaded, or None where it cannot be
    built or loaded."""
    if "lib" in _NATIVE:
        return _NATIVE["lib"]
    _NATIVE["lib"] = None
    if not NATIVE_SRC.exists():
        return None
    digest = hashlib.sha256(NATIVE_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libavimux-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", "-O2", "-Wall", "-fPIC", "-shared",
                            str(NATIVE_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.avimux_open.restype = ctypes.c_void_p
    lib.avimux_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_double, ctypes.c_int]
    lib.avimux_add_frame_rgb.restype = ctypes.c_int
    lib.avimux_add_frame_rgb.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.avimux_add_frame_jpeg.restype = ctypes.c_int
    lib.avimux_add_frame_jpeg.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_uint32]
    lib.avimux_close.restype = ctypes.c_int
    lib.avimux_close.argtypes = [ctypes.c_void_p]
    lib.avimux_abort.restype = None
    lib.avimux_abort.argtypes = [ctypes.c_void_p]
    _NATIVE["lib"] = lib
    return lib


class NativeAviWriter:
    """Streaming AVI writer backed by native/avimux.cc (``_native_lib``).

    Same interface as :class:`AviWriter` but constant-memory: frames go
    straight to disk (the C++ side converts RGB to the container's
    bottom-up BGR for "DIB "; "MJPG" frames are JPEG-encoded here and
    passed through).  Frame size is fixed at construction.
    """

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0,
                 codec: str = "MJPG", quality: int = 90):
        if codec not in ("MJPG", "DIB "):
            raise ValueError(f"unsupported codec {codec!r}")
        lib = _native_lib()
        if lib is None:
            raise RuntimeError("the native AVI muxer could not be built or "
                               "loaded (g++ missing?)")
        self._lib = lib
        self.codec = codec
        self.quality = quality
        self._wh = (width, height)
        self._h = lib.avimux_open(path.encode(), width, height,
                                  float(fps), 0 if codec == "DIB " else 1)
        if not self._h:
            raise OSError(f"avimux_open failed for {path!r}")

    def add_frame(self, frame) -> None:
        arr = to_uint8(frame)
        if arr.shape[:2][::-1] != self._wh or arr.shape[2] != 3:
            raise ValueError(f"expected {self._wh[::-1] + (3,)}, got {arr.shape}")
        if self.codec == "DIB ":
            rc = self._lib.avimux_add_frame_rgb(
                self._h, np.ascontiguousarray(arr).tobytes()
            )
        else:
            data = _jpeg(arr, self.quality)
            rc = self._lib.avimux_add_frame_jpeg(self._h, data, len(data))
        if rc != 0:
            raise OSError(f"avimux add_frame failed ({rc})")

    def close(self) -> None:
        if self._h:
            rc = self._lib.avimux_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError(f"avimux_close failed ({rc})")

    def abort(self) -> None:
        if self._h:
            self._lib.avimux_abort(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self.abort()


def open_avi(path: str, width: int, height: int, fps: float = 30.0,
             codec: str = "MJPG", quality: int = 90):
    """Best AVI writer available: native streaming muxer, else pure Python."""
    try:
        return NativeAviWriter(path, width, height, fps=fps, codec=codec,
                               quality=quality)
    except (RuntimeError, OSError):
        return AviWriter(path, fps=fps, codec=codec, quality=quality)


def compile_video(frame_paths, out_path: str, fps: float = 30.0,
                  codec: str = "MJPG") -> None:
    """Stitch image files into an AVI (Game1.compileVideo, Game1.cs:192-210)."""
    from raytpu_torch.io.image import read_image

    with AviWriter(out_path, fps=fps, codec=codec) as w:
        for p in frame_paths:
            w.add_frame(read_image(p))
