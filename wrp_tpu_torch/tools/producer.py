#!/usr/bin/env python3
"""Standalone producer shim: replay synthetic sectors onto the wire.

Equivalent to the reference's external data source in its localhost test
topology (SURVEY.md section 4.5); the same flags as `cli produce`:

    python3 wrp_tpu_torch/tools/producer.py --transport tcp --sectors 8
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from wrp_tpu_torch.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(["produce", *sys.argv[1:]]))
