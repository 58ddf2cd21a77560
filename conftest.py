"""A time limit for every test under the repository (``tests/`` and
``rtbench/tests/``), so that one hang fails one test instead of cutting the
run, and the ``slow`` mark for the tests listed in :data:`SLOW_TESTS`.
Standard library and pytest only: it is loaded on machines without JAX
too."""

import faulthandler
import hashlib
import os
import signal
import sys
from pathlib import Path

import pytest

#: Seconds each phase of a test (setup, call, teardown) may take: twice
#: the longest test of a whole run with six workers
#: (tests/test_utils_cli.py::TestCliDistribution::test_render_devices_ring,
#: 319 s).  Past it the test fails with its traceback and the run goes
#: on; a hang anywhere in a run of ~650 s fails before ~1,300 s.
TEST_TIME_LIMIT = 640
#: A Python signal handler runs only between bytecodes, never inside a long
#: XLA compile.  Past the limit and this margin, faulthandler dumps every
#: thread's stack and ends the process: under xdist only that worker,
#: which xdist reports as crashed in this test and replaces
#: (:func:`pytest_runtest_setup` keeps the replacement from running the
#: test again).
BACKSTOP_MARGIN = 60

#: Tests that take 300-440 s each on the CPU (340, 441, 375, 430 and 307 s,
#: in this order, in a run of their file alone): they call the JAX
#: package's sharded renders eagerly, and an eager ``shard_map`` body
#: compiles one operation at a time, again for every ring hop and bounce
#: level.  They are marked ``slow``; tests/test_dist_traced.py runs the
#: same tests with that render traced once under ``jax.jit``, 11-27 s
#: each.
SLOW_TESTS = (
    "tests/test_dist.py::TestRingRendering::"
    "test_ring_render_matches_replicated[False]",
    "tests/test_dist.py::TestRingRendering::"
    "test_ring_render_matches_replicated[True]",
    "tests/test_dist.py::TestRingDifferentiable::"
    "test_ring_render_differentiable_cfg_allowed",
    "tests/test_dist.py::test_sharded_multisampled_matches_single_device",
    "tests/test_dist.py::test_ring_sharded_atlas_bilinear_parity",
)
ROOT = Path(__file__).parent

_stderr = pytest.StashKey[int]()


def pytest_configure(config):
    # The backstop writes to a copy of stderr taken while no test's output
    # is captured: a dump into the capture file would die with the process.
    config.stash[_stderr] = os.dup(sys.__stderr__.fileno())
    signal.signal(signal.SIGALRM, _over_time)


def pytest_unconfigure(config):
    signal.signal(signal.SIGALRM, signal.SIG_DFL)
    os.close(config.stash[_stderr])


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    """Marks the items of :data:`SLOW_TESTS` ``slow``, before pytest's
    ``-m`` deselects by marks.  Once a file of the list is collected, every
    id listed for it must still name a test there; the ids are checked
    against the module, not the items, which ``-k`` or a node id may
    have left out."""
    checked = set()
    for item in items:
        path = item.path.relative_to(ROOT).as_posix()
        if path not in checked:
            checked.add(path)
            for nodeid in SLOW_TESTS:
                if nodeid.startswith(path + "::"):
                    _check_names_a_test(item.module, nodeid)
        if path + item.nodeid[item.nodeid.index("::"):] in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


def _check_names_a_test(module, nodeid):
    names, _, param = nodeid.split("::", 1)[1].partition("[")
    obj = module
    for name in names.split("::"):
        obj = getattr(obj, name, None)
    # Ids of a parametrized test as pytest forms them for plain values
    # of one argument (``str(value)``).
    ids = [str(value) for mark in getattr(obj, "pytestmark", ())
           if mark.name == "parametrize" for value in mark.args[1]]
    if obj is None or param and param[:-1] not in ids:
        raise pytest.UsageError(
            f"SLOW_TESTS lists {nodeid}, which names no test of "
            f"{module.__file__}")


def _over_time(signum, frame):
    pytest.fail(f"ran past its limit of {TEST_TIME_LIMIT} s")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    """Under xdist's ``--dist loadfile``, a crashed worker's whole file, the
    test that crashed it included, goes to its replacement, which would run
    that test into the backstop again, file after file.  So each test
    leaves a mark in the run's shared temporary directory as it starts,
    and a test that finds its mark already there fails at once."""
    if hasattr(item.config, "workerinput"):
        run_dir = Path(item.config.option.basetemp).parent
        mark = run_dir / hashlib.sha1(item.nodeid.encode()).hexdigest()
        if mark.exists():
            pytest.fail("a worker crashed while running this test "
                        "(see its output)")
        mark.touch()
    return (yield from _time_limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _time_limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    return (yield from _time_limited(item))


def _time_limited(item):
    """Runs one phase of a test under the limit.  The alarm is armed only
    inside the phase, so the handler's failure is raised where pytest
    reports it against the test."""
    faulthandler.dump_traceback_later(TEST_TIME_LIMIT + BACKSTOP_MARGIN,
                                      exit=True,
                                      file=item.config.stash[_stderr])
    signal.setitimer(signal.ITIMER_REAL, TEST_TIME_LIMIT)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
