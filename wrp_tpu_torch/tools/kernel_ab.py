#!/usr/bin/env python3
"""A/B timing of the port's kernels across source trees, on one GPU.

    python3 wrp_tpu_torch/tools/kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (e.g. the parent commit unpacked with
`git archive` into a git-ignored directory); each runs in its own process,
in the order given, so list them in turns (parent, change, change, parent)
to separate a code change from drift.  For each it builds the tree's kernel
library and prints one JSON line: the card, the CUDA-event ms per call of
the radix kernel (int16 and f32 input) and the wire kernel at 16 sectors
of 3 x 1024 x 512, the radix kernel at m = 960 (an L = 15 leaf), the
salted radix offset entry at the bench's 384 channel-sectors, the dense
entries at m = 1000 (16 sectors, and a launch of 384 channel-sectors
through `fused_chain_power_at`) with the body they took, `fused_stage2`
on Y [48, 512, 512] beside torch.matmul (complex64 Y @ B), and, where the
tree has them, the A-stage kernel at w = 512 and the row-epilogue kernel
on its Y, each with its rel-L2 against the tree's own plain version, and
the FFT-form kernels' blocks per SM and resident clusters where the tree
has them; the tensor-core probe at width 512 x 512 steps beside
torch.matmul bf16 (a batched matmul per step and, where the tree's
`mxu_occupancy` has it, one [m, ndots k] GEMM per step, each replayed
from a CUDA graph), and the split dot's device time per call from a CUDA
graph of 100 calls beside torch.matmul fp32's; the number of kernels and
of FFMA instructions in its library.  Last, one JSON line holds every kernel
the trees share by name whose `-Xptxas=-v` report (registers, stack,
spills, shared memory) or SASS FFMA count differs from the first tree's
("ptxas_differs", "ffma_differs"; kernels that are not in both trees, as
the FFT-form body against the matrix-form one, are not compared).  Needs
CUDA; imports only the tree's wrp_tpu_torch.

`ptxas_report` and `sass_opcode_counts` read a built library's compiler
log and SASS (cuobjdump, names demangled with cu++filt, both beside nvcc);
`wrp_tpu_torch/tools/kernel_breakdown.py` uses the latter.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path


def kernel_key(name: str) -> str:
    """A demangled kernel name as a key: no parameter list, no casts on
    integer template arguments ("(int)8" -> "8", "(bool)1" -> "1"), and the
    radix body's template argument written the same for the bool flag of
    earlier trees ((bool)0/1) and the Body enum of later ones
    ((wrp::Body)0/1): body0, body1, ..."""
    if name.endswith(")"):          # drop the parameter list
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = re.sub(r"\((?:unsigned |long |short )*(?:int|long|short|char|bool)\)"
                  r"(-?\d)", r"\1", name)
    name = re.sub(r"\((?:wrp::)?Body\)(\d)", r"\1", name)
    if "radix_chain_kernel" in name:
        name = re.sub(r",\s*(\d+),\s*(\d+),\s*(\d|false|true)>$",
                      lambda m: f", {m[1]}, {m[2]}, body"
                      f"{ {'false': '0', 'true': '1'}.get(m[3], m[3]) }>", name)
    return name


def _demangle(names, tool_dir: Path) -> dict:
    """{mangled: kernel_key of cu++filt's name}."""
    names = sorted(set(names))
    done = subprocess.run([str(tool_dir / "cu++filt")], input="\n".join(names),
                          capture_output=True, text=True, check=True, timeout=120)
    return {mangled: kernel_key(name)
            for mangled, name in zip(names, done.stdout.splitlines())}


def ptxas_report(log_text: str, tool_dir: Path) -> dict:
    """{kernel: "R regs, S stack, X/Y spill, Z smem"} of every entry
    function in a build log written with -Xptxas=-v."""
    rep, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            rep.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and not rep[cur].get("stack"):
            rep[cur].update(stack=m.group(1), spill=f"{m.group(2)}/{m.group(3)}")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            rep[cur].update(regs=m.group(1), smem=smem.group(1) if smem else "0")
            cur = None
    keys = _demangle(rep, tool_dir)
    return {keys[k]: (f"{v.get('regs')} regs, {v.get('stack')} stack, "
                      f"{v.get('spill')} spill, {v.get('smem')} smem")
            for k, v in rep.items()}


def sass_opcode_counts(so: Path, tool_dir: Path, opcodes=("FFMA",)) -> dict:
    """{kernel: {opcode: instructions of it in the kernel's SASS}} for every
    kernel in the built library `so` (cuobjdump --dump-sass); an opcode
    counts with any modifiers (LDS counts LDS.128), and "all" counts every
    instruction."""
    done = subprocess.run([str(tool_dir / "cuobjdump"), "--dump-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=300)
    counts, cur = {}, None
    # an instruction line: /*0a10*/  [@!P0] OPCODE.MODIFIERS operands ;
    instr = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
    for line in done.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            # a template instantiated in two sources is in two cubins: once
            cur = None if m.group(1) in counts else m.group(1)
            if cur is not None:
                counts[cur] = dict.fromkeys(opcodes, 0)
            continue
        m = instr.search(line) if cur is not None else None
        if m:
            for op in opcodes:
                if op in ("all", m.group(1)):
                    counts[cur][op] += 1
    keys = _demangle(counts, tool_dir)
    return {keys[k]: v for k, v in counts.items()}


def _measure(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import dataclasses

    import numpy as np
    import torch

    from wrp_tpu_torch import oracle
    from wrp_tpu_torch.config import DEFAULT_CONFIG as cfg
    from wrp_tpu_torch.constants import PipelineConstants
    from wrp_tpu_torch.io import codec
    from wrp_tpu_torch.ops import _build, device_codec, fullchain, postprocess
    from wrp_tpu_torch.pipeline import _DeviceConstants

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA GPU")
    _build.load_library()
    consts = PipelineConstants.build(cfg)
    plan = fullchain.build_plan(consts, "cuda")

    def sectors(c):
        noise = [oracle.synthetic_iq(c, kind="noise", seed=2024 + b)
                 for b in range(16)]
        x = torch.from_numpy(np.stack([
            np.stack([s.real, s.imag], -3).astype(np.int16) for s in noise
        ])).cuda().reshape(-1, 2, c.m, c.n)
        return noise, x

    noise, x16 = sectors(cfg)

    def ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def rel(ref, got):
        return float((got.double() - ref.double()).norm() / ref.double().norm())

    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    # the tree's plain version of the radix and wire kernels
    plain = getattr(fullchain, "fft_chain_power_reference",
                    fullchain.fused_chain_power_reference)
    out["radix_ms"] = ms(lambda: fullchain.fused_chain_power_radix(x16, plan))
    xf = x16.float()
    out["radix_f32_ms"] = ms(lambda: fullchain.fused_chain_power_radix(xf, plan))
    out["radix_rel"] = rel(plain(x16, plan),
                           fullchain.fused_chain_power_radix(x16, plan))
    x384 = x16.repeat(8, 1, 1, 1).contiguous()
    out["radix_salted_384_ms"] = ms(lambda: fullchain.fused_chain_power_radix(
        x384, plan, offset=0, bc=384, salt=7))
    del x384
    # the L = 15 leaf (m = 960 = 64 x 15) through the radix kernel
    lcfg = dataclasses.replace(cfg, num_range_cells=960)
    lplan = fullchain.build_plan(PipelineConstants.build(lcfg), "cuda")
    _, l16 = sectors(lcfg)
    out["radix_960_ms"] = ms(lambda: fullchain.fused_chain_power_radix(l16, lplan))
    out["radix_960_rel"] = rel(plain(l16, lplan),
                               fullchain.fused_chain_power_radix(l16, lplan))
    del l16
    # the dense entries at m = 1000 (radix_for(1000) == 1), and the body
    # they take (trees before the FFT route: the matrix kernel)
    dcfg = dataclasses.replace(cfg, num_range_cells=1000)
    dplan = fullchain.build_plan(PipelineConstants.build(dcfg), "cuda")
    _, d16 = sectors(dcfg)
    body = getattr(fullchain, "dense_body", lambda m: "matrix")(1000)
    dplain = (fullchain.fft_chain_power_reference if body == "fft"
              else fullchain.fused_chain_power_reference)
    out["dense_body"] = body
    out["dense_ms"] = ms(lambda: fullchain.fused_chain_power_dense(d16, dplan))
    out["dense_rel"] = rel(dplain(d16, dplan),
                           fullchain.fused_chain_power_dense(d16, dplan))
    d384 = d16.repeat(8, 1, 1, 1).contiguous()
    out["dense_at_384_ms"] = ms(lambda: fullchain.fused_chain_power_at(
        d384, 0, 384, dplan), 10)
    del d384, d16
    # fused_stage2 on Y [48, 512, 512] and the library's complex64 Y @ B
    dc = _DeviceConstants(consts, torch.device("cuda"))
    rng = np.random.default_rng(2024)
    yr, yi = (torch.from_numpy((rng.standard_normal((48, cfg.m // 2, cfg.n))
                                * 1e-3).astype(np.float32)).cuda()
              for _ in range(2))
    taps = consts.ma_taps
    out["stage2_ms"] = ms(lambda: postprocess.fused_stage2(yr, yi, dc.br, dc.bi,
                                                           taps))
    out["stage2_rel"] = rel(
        postprocess.fused_stage2_reference(yr, yi, dc.br, dc.bi, taps),
        postprocess.fused_stage2(yr, yi, dc.br, dc.bi, taps))
    yc, bcx = torch.complex(yr, yi), torch.complex(dc.br, dc.bi)
    out["stage2_matmul_c64_ms"] = ms(lambda: torch.matmul(yc, bcx))
    del yr, yi, yc
    # trees before the FFT form built the wire kernel's channel-tiled
    # constants only on request
    try:
        wplan = fullchain.build_plan(consts, "cuda", channels=cfg.num_channels)
    except TypeError:
        wplan = plan
    wires = np.stack([np.frombuffer(codec.encode_iq(s, cfg), np.uint8)
                      for s in noise])
    w32 = device_codec.wire_words_i32(torch.from_numpy(wires).cuda(),
                                      cfg).contiguous()
    out["wire_ms"] = ms(lambda: fullchain.fused_chain_power_wire(
        w32, wplan, cfg.num_channels))
    if hasattr(fullchain, "fused_chain_astage"):
        y = fullchain.fused_chain_astage(x16, plan)
        out["astage_ms"] = ms(lambda: fullchain.fused_chain_astage(x16, plan))
        out["astage_rel"] = rel(
            fullchain.fused_chain_astage_reference(x16, plan), y)
        out["rows_ms"] = ms(lambda: fullchain.parseval_rows_power(y, plan))
        out["rows_rel"] = rel(fullchain.parseval_rows_power_reference(y, plan),
                              fullchain.parseval_rows_power(y, plan))
    if hasattr(fullchain, "fft_occupancy"):
        out["occupancy"] = {body: fullchain.fft_occupancy(plan, body)
                            for body in ("radix", "wire", "astage")}
    _probes(out, ms, rel)
    so = _build.library_path()
    tool_dir = Path(_build._nvcc()).parent
    out["ptxas"] = ptxas_report(so.with_suffix(".log").read_text(), tool_dir)
    out["ffma"] = {k: v["FFMA"]
                   for k, v in sass_opcode_counts(so, tool_dir).items()}
    return out


def graph_ms(fn, calls: int = 100) -> float:
    """Device ms per call of fn: `calls` calls captured once in a CUDA graph
    (warmed on a side stream first), the best of 5 replays timed with CUDA
    events.  The host's work per call (Python, ctypes) is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / calls)
    return best


def _probes(out: dict, ms, rel) -> None:
    """The tensor-core probe (#11) and the split dot (#12) at the tools'
    default shapes, with their library yardsticks (the same in every tree:
    they time the library, not the tree)."""
    import numpy as np
    import torch

    from wrp_tpu_torch.ops import probes
    from wrp_tpu_torch.tools import mxu_occupancy

    torch.backends.cuda.matmul.allow_tf32 = False
    bf = torch.bfloat16
    m, k, lanes, distinct, width, steps = 128, 384, 24 * 512, 4, 512, 512
    nd = lanes // width
    rng = np.random.default_rng(2024)
    a = torch.from_numpy(rng.standard_normal((nd, m, k), dtype=np.float32)
                         ).to(bf).cuda()
    x = torch.from_numpy(rng.standard_normal((k, distinct * 2048),
                                             dtype=np.float32)).to(bf).cuda()

    out["tc_ms"] = ms(lambda: probes.tc_dot_probe(a, x, width, steps,
                                                  distinct, lanes), 10)
    out["tc_rel"] = rel(probes.tc_dot_probe_reference(a, x, width, 32,
                                                      distinct, lanes),
                        probes.tc_dot_probe(a, x, width, 32, distinct, lanes))
    out["tc_library_ms"] = ms(mxu_occupancy.library_steps(
        a, x, width, steps, distinct, nd), 10)
    if hasattr(mxu_occupancy, "library_kcat_steps"):
        out["tc_library_kcat_ms"] = ms(mxu_occupancy.library_kcat_steps(
            a, x, width, steps, distinct, nd), 10)
    rng = np.random.default_rng(0)
    x14 = torch.from_numpy(rng.integers(-8192, 8192, (128, 512),
                                        dtype=np.int16)).cuda()
    a14 = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32)
                           ).to(bf).cuda()
    af, xf = a14.float(), x14.float()
    out["split_graph_ms"] = graph_ms(
        lambda: probes.int_split_dot(x14, a14, "int"))
    out["split_rel"] = rel(probes.int_split_dot_reference(x14, a14, "int"),
                           probes.int_split_dot(x14, a14, "int"))
    out["split_library_graph_ms"] = graph_ms(lambda: torch.matmul(af, xf))


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(_measure(argv[2])), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    results = []
    for tree in argv[1:]:
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], stdout=subprocess.PIPE,
                              text=True, timeout=600)
        rc = rc or done.returncode
        if done.returncode != 0:
            continue
        r = json.loads(done.stdout.strip().splitlines()[-1])
        results.append(r)
        print(json.dumps({**{k: v for k, v in r.items()
                             if k not in ("ptxas", "ffma")},
                          "kernels": len(r["ptxas"]),
                          "ffma_total": sum(r["ffma"].values())}), flush=True)
    if results:
        first = results[0]
        summary = []
        for r in results[1:]:
            diff = {}
            for key in ("ptxas", "ffma"):
                common = sorted(set(first[key]) & set(r[key]))
                diff[key] = {"shared": len(common), "differs": {
                    k: [first[key][k], r[key][k]] for k in common
                    if first[key][k] != r[key][k]}}
            summary.append({"tree": r["tree"], "vs": first["tree"],
                            "ptxas_shared": diff["ptxas"]["shared"],
                            "ptxas_differs": diff["ptxas"]["differs"],
                            "ffma_shared": diff["ffma"]["shared"],
                            "ffma_differs": diff["ffma"]["differs"]})
        print(json.dumps({"compiled_vs_first_tree": summary}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
