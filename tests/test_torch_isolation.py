"""The port stands alone: it imports neither JAX nor wrp_tpu (the machine
with the GPU has no JAX)."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|wrp_tpu)\b", re.M)


def test_port_imports_without_jax():
    from conftest import cpu_subprocess_env

    code = ("import sys; import wrp_tpu_torch, wrp_tpu_torch.cli, "
            "wrp_tpu_torch.runtime.executor, wrp_tpu_torch.ops.fullchain, "
            "wrp_tpu_torch.ops._build, wrp_tpu_torch.parallel.multihost, "
            "wrp_tpu_torch.bench, wrp_tpu_torch.ops.dft, "
            "wrp_tpu_torch.ops.postprocess, wrp_tpu_torch.ops.probes, "
            "wrp_tpu_torch.tools.kernel_breakdown, "
            "wrp_tpu_torch.tools.mxu_occupancy, "
            "wrp_tpu_torch.tools.int_split_repro; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'wrp_tpu.')) or m == 'wrp_tpu'); "
            "assert not bad, bad; print('clean')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=cpu_subprocess_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_port_sources_import_no_jax():
    files = sorted((REPO / "wrp_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files
                 if IMPORT_RE.search(f.read_text())]
    assert offenders == []
