#!/usr/bin/env python3
"""Standalone result consumer shim (visualiser stand-in, cf. the
reference's receive.cpp smoke tool); the same flags as `cli consume`:

    python3 wrp_tpu_torch/tools/consumer.py --transport tcp --count 8
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from wrp_tpu_torch.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(["consume", *sys.argv[1:]]))
