"""
``python -m lidbox_tpu_torch`` entry point (counterpart of
``lidbox_tpu.__main__``; see lidbox_tpu_torch/cli.py).
"""
import sys

from lidbox_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
