"""What binds the port's CUDA kernels: SASS instruction counts, the measured
IMAD rate and the share of the integer issue slots each kernel fills.

    python -m eigen_zkvm_tpu_torch.kernel_probe        # needs one GPU + nvcc

It builds the kernels, disassembles the library with `cuobjdump -sass`,
counts each kernel's instructions by class (with every loop, found by its
backward branch, listed on its own), times the IMAD micro-kernel
(csrc/imad_probe.cu) and both kernels at the main path's shapes, and prints
the instructions executed over the time and over the card's integer issue
slots (SMs x 64 lanes x the SM clock the micro-kernel ran at).  The last
line is the report as JSON.

The executed count of a kernel is its static count with each loop body
taken `trips` times; Poseidon's only loop is the 22 partial rounds, unrolled
kPartialUnroll at a time (read from csrc/poseidon_gl.cu).  The
NTT's loops depend on the shape, so it is read per butterfly from the loop of
each register pass: a radix-2^r pass does r * 2^(r-1) butterflies a trip and
2^r - 1 table products, each four IMAD.WIDE.U32.

BN254 (csrc/bn254.cuh): the never-launched kernels of csrc/bn254_probe.cu
each hold one loop whose body is one primitive, so the body's count is the
instructions of one Fq product, Fq square, Fq2 product, mixed addition (G1,
G2; its body holds the inlined doubling of P + P as well) and G1 doubling;
every loop of the MSM and fixed-base kernels is listed with the rest.
"""
from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

INT_OPS = ("IMAD", "IADD3", "IADD", "LOP3", "ISETP", "SEL", "SHF", "LEA",
           "PRMT", "MOV", "IABS", "FLO", "POPC", "BREV", "VIADD", "UIADD3",
           "ULOP3", "USHF", "UIMAD", "UMOV", "USEL", "UISETP", "ULEA", "CS2R")
MEM_OPS = ("LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LD", "ST", "LDL",
           "STL", "LDSM", "ATOM", "RED")
SM_COUNT_LANES = 64     # integer lanes a clock on one SM (assumed peak)
PARTIAL_ROUNDS = 22


def poseidon_loop_trips() -> int:
    """Trips of the Poseidon kernel's partial-round loop: 22 rounds over the
    unroll factor its source sets."""
    from . import kernels

    with open(os.path.join(kernels.CSRC, "poseidon_gl.cu")) as f:
        m = re.search(r"kPartialUnroll = (\d+)", f.read())
    return PARTIAL_ROUNDS // int(m.group(1)) if m else PARTIAL_ROUNDS


def _klass(op: str) -> str:
    base = op.split(".")[0]
    if base in INT_OPS:
        return "int"
    if base in MEM_OPS:
        return "mem"
    return "other"


def disassemble(lib_path: str) -> dict:
    """{kernel name: [(address, opcode, branch target or None), ...]}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    kernels, cur = {}, None
    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)"
                     r"([^;]*);")
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernels.setdefault(m.group(1), [])
            continue
        m = ins.search(line)
        if m and cur is not None:
            addr, op, rest = int(m.group(1), 16), m.group(2), m.group(3)
            tgt = None
            if op.startswith("BRA"):
                t = re.search(r"0x([0-9a-f]+)", rest)
                tgt = int(t.group(1), 16) if t else None
            cur.append((addr, op, tgt))
    return kernels


def _hist(instrs) -> dict:
    h = collections.Counter(_klass(op) for _, op, _ in instrs)
    h["imad_wide"] = sum(op.startswith("IMAD.WIDE") for _, op, _ in instrs)
    h["imad"] = sum(op.split(".")[0] == "IMAD" for _, op, _ in instrs)
    h["total"] = len(instrs)
    return dict(h)


def _top(instrs, n: int = 8) -> list:
    return collections.Counter(op for _, op, _ in instrs).most_common(n)


def summarize(instrs) -> dict:
    """Static histogram and every loop (backward branch) with its body's."""
    loops = []
    for addr, op, tgt in instrs:
        if tgt is not None and tgt <= addr:
            body = [i for i in instrs if tgt <= i[0] <= addr]
            loops.append({"from": tgt, "to": addr, **_hist(body)})
    return {"static": _hist(instrs), "top": _top(instrs), "loops": loops}


def executed(summary: dict, trips: int, key: str = "int") -> int:
    """Static count with every loop body taken `trips` times."""
    return summary["static"].get(key, 0) + (trips - 1) * sum(
        lp.get(key, 0) for lp in summary["loops"])


def imad_rate(dev, wide: bool, iters: int = 4096) -> dict:
    """IMADs a clock an SM, from the slowest block's clock64() span, and
    the SM clock the run held (cycles over the event time)."""
    import torch

    from . import kernels

    lib = kernels.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(1, dtype=torch.int64, device=dev)
    cycles = torch.zeros(sms, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        kernels.check("imad_probe", lib.imad_probe(
            dev.index, int(wide), sms, iters, sink.data_ptr(),
            cycles.data_ptr(), stream))

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    per_sm = 1024 * lib.imad_probe_chains() * iters
    worst = int(cycles.max())
    return {"per_clock_per_sm": per_sm / worst, "ms": ms, "sms": sms,
            "clock_ghz": worst / (ms * 1e6),
            "per_s": per_sm * sms / (ms * 1e-3)}


def imad_issue(dev) -> dict:
    """The IMAD.WIDE.U32 rate of the micro-kernel and the rate at which its
    loop issues integer instructions of every kind: ptxas keeps some of the
    64-bit accumulations as separate adds, so the loop's SASS says how many
    instructions go with each multiply-add."""
    from . import kernels

    rate = imad_rate(dev, True)
    loops = [lp for name, ins in disassemble(kernels.LIB_PATH).items()
             if "imad_probe" in name for lp in summarize(ins)["loops"]
             if lp["imad_wide"]]
    body = max(loops, key=lambda lp: lp["total"])
    per_mad = body["int"] / body["imad_wide"]
    return {"imads_per_clock_per_sm": rate["per_clock_per_sm"],
            "instructions_per_clock_per_sm":
                rate["per_clock_per_sm"] * per_mad,
            "loop_int_instructions": body["int"],
            "loop_imad_wide": body["imad_wide"],
            "clock_ghz": rate["clock_ghz"], "per_s": rate["per_s"]}


def _time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bn254_bodies(sass: dict) -> dict:
    """{probe kernel: its loop body's histogram}: one BN254 primitive a
    trip (csrc/bn254_probe.cu); printed with the IMAD.WIDE.U32 share."""
    out = {}
    for name, s in sorted(sass.items()):
        if not name.startswith("probe_") or not s["loops"]:
            continue
        body = max(s["loops"], key=lambda lp: lp["total"])
        out[name] = body
        print(f"bn254 {name[len('probe_'):]}: {body['total']} instructions "
              f"a trip ({body.get('int', 0)} integer, {body['imad_wide']} "
              f"IMAD.WIDE, {body.get('mem', 0)} memory)")
    return out


def main() -> int:
    import numpy as np
    import torch

    from . import kernels
    from .ops import gl, ntt, poseidon
    from .utils.devices import card_line, cuda_device

    dev = cuda_device(0)
    card = card_line()
    print(f"card: {card}")
    info = kernels.build(force=True)
    print(f"build: {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.split("info    :")[-1].strip())
    sass = {name: summarize(ins)
            for name, ins in disassemble(kernels.LIB_PATH).items()}
    for name, s in sass.items():
        print(f"sass {name}: static {s['static']} top {s['top']}")
        for lp in s["loops"]:
            if lp["total"] < 50:
                continue
            line = f"  loop {lp}"
            # a register pass of the NTT: 2^r - 1 table products a trip
            r = {4: 1, 12: 2, 28: 3, 60: 4}.get(lp["imad_wide"])
            if ("ntt" in name and r and lp["total"] > 40 * r
                    and lp.get("mem", 0) <= 3 << r):
                line += (f"  radix-{1 << r} pass: "
                         f"{lp['total'] / (r << (r - 1)):.1f} instructions "
                         f"a butterfly")
            print(line)

    report_bn254 = bn254_bodies(sass)

    wide = imad_rate(dev, True)
    narrow = imad_rate(dev, False)
    issue = imad_issue(dev)
    print(f"IMAD.WIDE.U32: {wide['per_clock_per_sm']:.2f} a clock an SM "
          f"({wide['per_s'] / 1e12:.3f} T/s at {wide['clock_ghz']:.3f} GHz), "
          f"in a loop of {issue['loop_int_instructions']} integer "
          f"instructions for {issue['loop_imad_wide']} IMAD.WIDE, so "
          f"{issue['instructions_per_clock_per_sm']:.2f} integer instructions "
          f"a clock an SM; 32-bit IMAD: {narrow['per_clock_per_sm']:.2f} a "
          f"clock an SM ({narrow['per_s'] / 1e12:.3f} T/s)")
    slots_per_s = wide["sms"] * SM_COUNT_LANES * wide["clock_ghz"] * 1e9

    rng = np.random.default_rng(7)

    def rand(*shape):
        return gl.from_u64(rng.integers(0, 2**64, size=shape, dtype=np.uint64)
                           % np.uint64(gl.P_INT), dev)

    report = {"card": card, "imad_wide": wide, "imad_32": narrow,
              "imad_issue": issue,
              "sass": sass, "slots_per_s": slots_per_s,
              "bn254": report_bn254}
    pos = next((s for n, s in sass.items() if "poseidon" in n), None)
    if pos is not None:
        B = 1 << 20
        st = rand(B, 12)
        ms = _time_ms(lambda: poseidon.permute(st))
        trips = poseidon_loop_trips()
        per_perm = executed(pos, trips)
        all_perm = executed(pos, trips, "total")
        share = per_perm * B / (ms * 1e-3) / slots_per_s
        print(f"poseidon permute B=2^20: {ms:.3f} ms; {per_perm} integer "
              f"instructions a permutation ({all_perm} of every class, "
              f"{executed(pos, trips, 'imad_wide')} IMAD.WIDE); "
              f"integer issue share {share:.3f}")
        report["poseidon"] = {"ms": ms, "int_per_perm": per_perm,
                              "all_per_perm": all_perm, "issue_share": share}
    x = rand(1 << 20, 8)
    ms = _time_ms(lambda: ntt.interpolate(x, 20, 21))
    report["ntt_interpolate_ms"] = ms
    print(f"ntt interpolate [2^20,8]->[2^21,8]: {ms:.3f} ms")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
