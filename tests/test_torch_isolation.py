"""The port stands alone: it imports neither JAX nor wrp_tpu (the machine
with the GPU has no JAX)."""

import argparse
import re
import subprocess
import sys
from pathlib import Path

import pytest

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
            "wrp_tpu_torch.tools.int_split_repro, "
            "wrp_tpu_torch.native.codec_native, "
            "wrp_tpu_torch.native.ingest_native, "
            "wrp_tpu_torch.io.tcp, wrp_tpu_torch.io.zmq_io, "
            "wrp_tpu_torch.runtime.supervisor, "
            "wrp_tpu_torch.tools.producer, wrp_tpu_torch.tools.consumer, "
            "wrp_tpu_torch.parallel.halo, wrp_tpu_torch.parallel.dryrun, "
            "wrp_tpu_torch.parallel.launch, wrp_tpu_torch.viz, "
            "wrp_tpu_torch.tools.trace_summary, "
            "wrp_tpu_torch.tools.hw_parity, wrp_tpu_torch.tools.wire_ab, "
            "wrp_tpu_torch.tools.decode_ab, wrp_tpu_torch.tools.ab_sweep, "
            "wrp_tpu_torch.tools.multihost_bench, "
            "wrp_tpu_torch.tools.consolidation_soak; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'wrp_tpu.')) or m == 'wrp_tpu'); "
            "assert not bad, bad; "
            # pyzmq is imported where a ZMQ socket is built, not at import
            "assert 'zmq' not in sys.modules; print('clean')")
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


def test_port_keeps_its_own_native_sources():
    """wrp_tpu_torch/native/ holds its own C++ copies (natural row order:
    no radix permutation), which build.py compiles, and no built library."""
    native = REPO / "wrp_tpu_torch" / "native"
    from wrp_tpu_torch.native import build

    assert [p.name for p in build.SOURCES] == ["codec.cpp", "ingest.cpp"]
    assert all(p.parent == native and p.is_file() for p in build.SOURCES)
    assert build.BUILD_DIR == REPO / "wrp_tpu_torch" / "_build"
    assert "dest_row(" not in (native / "codec.cpp").read_text()
    assert not list(native.glob("*.so"))


#: wrp_tpu flags the port leaves out by design: rows stay in natural order
#: and the kernels read radix branches by index
BY_DESIGN = {("stream", "--wire-order")}


def _subcommands(ap: argparse.ArgumentParser) -> dict:
    """{subcommand: its option strings and positional names}."""
    sub = next(a for a in ap._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {s for a in p._actions for s in a.option_strings}
            | {a.dest for a in p._actions if not a.option_strings}
            for name, p in sub.choices.items()}


def test_cli_parser_has_every_wrp_tpu_flag(monkeypatch):
    """Every subcommand and flag of wrp_tpu/cli.py's parser is in the
    port's, but the by-design list; wrp_tpu's parser is taken from its
    main(), stopped at parse_args."""
    import wrp_tpu.cli as jcli
    from wrp_tpu_torch import cli

    class Parsed(Exception):
        pass

    def stop(self, *args, **kwargs):
        raise Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(Parsed) as parsed:
        jcli.main([])
    monkeypatch.undo()
    theirs = _subcommands(parsed.value.args[0])
    mine = _subcommands(cli.build_parser())
    assert set(theirs) <= set(mine), sorted(set(theirs) - set(mine))
    missing = {(name, flag) for name, flags in theirs.items()
               for flag in flags - mine[name]}
    assert missing == BY_DESIGN
    assert {"compare", "volume"} <= set(mine)
    assert "--timings" in mine["process"] and "--trace" in mine["stream"]
