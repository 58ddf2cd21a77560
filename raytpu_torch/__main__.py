"""``python -m raytpu_torch`` — CLI dispatch (see raytpu_torch/cli/main.py)."""

import sys

from raytpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
