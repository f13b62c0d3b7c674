"""Time the big-field Poseidon kernel (csrc/poseidon_fr.cu): one tree of
the port call by call, every group size at a prove's shapes, source
variants, and whole big-field proves.

    python eigen_zkvm_tpu_torch/bench_poseidon_fr.py [--root DIR] [--split]
        [--sweep] [--variants] [--chain "BENCH_CHAIN ARGS"]...

Imports `eigen_zkvm_tpu_torch` from DIR (a checkout of this repository,
this one by default, or another to compare two in one call) and loads the
sources the big-field prover runs alone (`kernels.load` of
csrc/{ntt,poseidon_gl,poseidon_fr}.cu), which build in seconds where the
whole library takes minutes.

--split     one BN128 tree over 2^17 random rows of width 12 and one over
            2^17 rows of width 0 (`tree_split`): the leaves' hash and each
            level's, timed with CUDA events at `commit_big.build_nodes`'
            on_call; the mean of three builds after a warm-up.
--sweep     each group size `lane_choices(t)` allows, beside `plan`'s
            pick, at the shapes of a prove: t = 17 levels of 1, 2, 32,
            512, 1,024, 2,048, 4,096, 8,192 and 16,384 nodes, 2^17 and
            2^21 t = 5 leaves, 2^14 t = 14.
--variants  the kernel's source with one constant or line replaced
            (POSEIDON_FR_VARIANTS, built and checked bit for bit against
            the source as it stands by kernel_tune's runner) at the
            shapes of a prove.
--chain     bench_chain.main on the argument string, repeatable.

The card's name and power limit come first; the last line is one JSON
object.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import sys

SOURCES = ("ntt.cu", "poseidon_gl.cu", "poseidon_fr.cu")
TREE_ROWS, TREE_WIDTH = 1 << 17, 12
SWEEP = [(17, 1), (17, 2), (17, 32), (17, 512), (17, 1024), (17, 2048),
         (17, 4096), (17, 1 << 13), (17, 1 << 14), (5, 1 << 17),
         (5, 1 << 21), (14, 1 << 14)]
# variant name -> [(file, old text, new text), ...]
POSEIDON_FR_VARIANTS = {
    "base": [],
    "group kernel registers for 3 blocks an SM (170)": [
        ("poseidon_fr.cu", "kMinBlocks = 4", "kMinBlocks = 3")],
    "group kernel registers uncapped": [
        ("poseidon_fr.cu", "kMinBlocks = 4", "kMinBlocks = 1")],
    "x^5 squares by bn254::mul": [
        ("poseidon_fr.cu",
         "const Fp<F> x2 = bn254::sqr_sos(x);\n"
         "  return bn254::mul(bn254::sqr_sos(x2), x);",
         "const Fp<F> x2 = bn254::mul(x, x);\n"
         "  return bn254::mul(bn254::mul(x2, x2), x);")],
}


def _states(dev, B: int, t: int, seed: int):
    """(inp [B, t-1, 4], init [B, 4]) of random values below 2^253."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = torch.randint(-2**63, 2**63 - 1, (B, t, 4), dtype=torch.int64,
                       device=dev, generator=gen)
    st[..., 3] &= (1 << 61) - 1
    return st[:, 1:].contiguous(), st[:, 0].contiguous()


def tree_split(dev, width: int, builds: int = 3) -> dict:
    """One BN128 tree over TREE_ROWS random rows of `width`: the time of
    its leaves' hash and of each level's, in order (CUDA events recorded
    by build_nodes' on_call), the mean over `builds` timed builds after a
    warm-up, with the Poseidon-Fr launches of one build."""
    import numpy as np
    import torch

    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import commit_big, gl

    rng = np.random.default_rng(width)
    rows = gl.from_u64(rng.integers(0, 2**64, size=(TREE_ROWS, width),
                                    dtype=np.uint64)
                       % np.uint64(gl.P_INT), dev)
    commit_big.build_nodes(bi.FR, rows)  # warm-up
    torch.cuda.synchronize()
    steps, launches = [], kernels.POSEIDON_FR.launches
    for _ in range(builds):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark():
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        commit_big.build_nodes(bi.FR, rows, on_call=mark)
        torch.cuda.synchronize()
        steps.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    launches = (kernels.POSEIDON_FR.launches - launches) // builds
    split = [sum(s[i] for s in steps) / builds for i in range(len(steps[0]))]
    counts, _ = commit_big.level_layout(TREE_ROWS)
    return {"width": width, "rows": TREE_ROWS, "levels": counts[1:],
            "steps_ms": split, "build_ms": sum(split),
            "launches": launches}


def sweep(dev) -> list:
    import torch

    from eigen_zkvm_tpu_torch.kernel_probe import _time_ms
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import poseidon_fr

    out = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for t, B in SWEEP:
        n_p = poseidon_fr.poseidon(bi.FR).n_rounds_p(t)
        inp = torch.zeros((B, t - 1, 4), dtype=torch.int64, device=dev)
        inp[..., 0] = torch.arange(B * (t - 1), device=dev).view(B, t - 1)
        init = torch.zeros((B, 4), dtype=torch.int64, device=dev)
        pick = poseidon_fr.plan(t, n_p, B, sms)
        row = {"t": t, "B": B, "plan": pick, "ms": {}}
        reps = 3 if B >= 1 << 20 else 10
        for g in poseidon_fr.lane_choices(t):
            row["ms"][g] = _time_ms(lambda: poseidon_fr.permute(
                bi.FR, t, inp, init, 1, lanes=g), reps)
        print(f"sweep t={t} B={B}: plan {pick}; " + ", ".join(
            f"G={g} {ms:.3f} ms" for g, ms in row["ms"].items()), flush=True)
        out.append(row)
    return out


def variants(dev) -> None:
    """Each of POSEIDON_FR_VARIANTS at a prove's shapes, on `plan`'s group
    size and on the other one the sweep left close."""
    from eigen_zkvm_tpu_torch.kernel_tune import _run_variants
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import poseidon_fr

    cases = []
    for t, B, lanes in ((5, 1 << 17, 1), (17, 1 << 13, 4), (17, 1 << 14, 1),
                        (17, 1 << 14, 4), (14, 1 << 14, 1), (17, 512, 32),
                        (17, 1, 32)):
        inp, init = _states(dev, B, t, t * B)
        cases.append((f"t={t} B={B} G={lanes}",
                      lambda t=t, inp=inp, init=init, g=lanes:
                      poseidon_fr.permute(bi.FR, t, inp, init, 1, g)))
    _run_variants("poseidon_fr.cu", POSEIDON_FR_VARIANTS, {"poseidon_fr"},
                  lambda lib: None, cases)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--chain", action="append", default=[],
                    metavar="ARGS")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.utils.devices import card_line, cuda_device

    dev = cuda_device(0)
    report = {"root": root, "card": card_line()}
    print(f"card: {report['card']}; tree {root}", flush=True)
    info = kernels.load(SOURCES)
    report["build_s"] = info["seconds"]
    print(f"build of {', '.join(SOURCES)}: {info['seconds']:.2f} s",
          flush=True)
    entry = ""
    for line in info["log"].splitlines():
        text = line.split("info    :")[-1].strip()
        if "Compiling entry function" in text:
            entry = text.split("'")[1] if "'" in text else text
        elif "poseidon_fr" in entry and ("registers" in text
                                         or "spill" in text):
            print(f"  ptxas: {entry}: {text}")
    ok = True
    if args.split:
        report["split"] = []
        for width in (TREE_WIDTH, 0):
            s = tree_split(dev, width)
            report["split"].append(s)
            print(f"tree 2^17 x {width} (BN128), {s['launches']} launches: "
                  f"{s['build_ms']:.3f} ms; leaves "
                  f"{s['steps_ms'][0]:.3f} ms; "
                  + "; ".join(f"level of {n} {ms:.3f} ms" for n, ms in
                              zip(s["levels"], s["steps_ms"][1:])),
                  flush=True)
    if args.sweep:
        report["sweep"] = sweep(dev)
    if args.variants:
        variants(dev)
    if args.chain:
        from eigen_zkvm_tpu_torch import bench_chain

        report["chain_rc"] = [bench_chain.main(shlex.split(a))
                              for a in args.chain]
        ok = ok and not any(report["chain_rc"])
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
