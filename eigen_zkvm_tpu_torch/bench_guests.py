"""The zkVM guests on one CUDA device: the committed guest ELFs run, the EVM
value-transfer guest proved.

    python -m eigen_zkvm_tpu_torch.bench_guests [--budget 512] [--device cpu]

First each committed guest ELF runs to its end on the native executor
(zkvm/rv32_native.py) and its final a0 is held to its oracle: the three
LLVM-built guests (data/llvm_guests/, `guests_llvm.*_expected()`) and the
EVM interpreter guest on the token contract (data/guests/evm_token.elf.gz,
`guest_evm_c.TOKEN_A0`).  Then the EIP-1559 value transfer of
data/guests/transfer_state.json (a made-up state test in the reference's
format) is proved on the card through `zkvm.evm.prove_state_test`: one
RV32IM machine set up at 2^NBITS rows, the run split into chunks of
`--budget` rows (two at 512; one without), each traced, proved and
self-verified, the chunks chained; prove_state_test holds the last one's
mem_out* to the digest of the post-state image, whose accounts must be the
file's postState.  The NTT's and Poseidon's counts are set to 0 just before the
prove and read just after.  EIGEN_ZKVM_SYNC=1 (set here) drains the device
at every stage tick, so the stage walls are device walls.  Only the GL
kernels (csrc/ntt.cu, csrc/poseidon_gl.cu) are built.

The guests are built on the CPU by the port's toolchains (zkvm/cc.py on
pycparser, zkvm/llvm_backend.py on libLLVM-15); this module imports
neither.  The last line is JSON: the runs, the setup's and each chunk's
stages, launches, each chunk's zkin sha256 (chip_smoke.GUESTS_SHA256 is
the JAX host engine's).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

STATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "guests", "transfer_state.json")
NBITS, BUDGET, QUERIES = 11, 512, 2
GL_SOURCES = ("ntt.cu", "poseidon_gl.cu")


def run_elfs() -> list:
    """Each committed guest ELF run to its end on the native executor: its
    cycles, final a0, oracle and seconds."""
    import numpy as np

    from .zkvm import elf, guest_evm_c, guests_llvm, rv32_native

    runs = [(f"llvm {name}", guests_llvm.load_fixture(name),
             guests_llvm.GUESTS[name][1]() & 0xFFFFFFFF)
            for name in sorted(guests_llvm.GUESTS)]
    runs.append(("evm token", guest_evm_c.load_token_elf(),
                 guest_evm_c.TOKEN_A0))
    out = []
    for name, blob, want in runs:
        t0 = time.perf_counter()
        program, entry, image0, ram_words, mem_base = elf.load_elf(
            blob, include_exec_in_image=False)
        ctx = rv32_native.NativeRun(program, entry, mem_words=np.asarray(
            image0, dtype=np.uint32), mem_base=mem_base, n_words=ram_words)
        rc, cycles, _rows, _ = ctx.run(max_cycles=1 << 26)
        a0 = int(ctx.regs[10])
        out.append(dict(name=name, cycles=cycles, a0=a0, want=want,
                        ok=rc == rv32_native.RV_HALTED and a0 == want,
                        s=time.perf_counter() - t0))
    return out


def _split(stages) -> tuple:
    """prove_state_test's ticks -> (the setup's: execute, machine, const
    tree, starkinfo compile; [each chunk's: trace ... verify])."""
    first = next(i for i, (st, _) in enumerate(stages) if st == "trace")
    chunks, cur = [], []
    for st, sec in stages[first:]:
        cur.append((st, sec))
        if st == "verify":
            chunks.append(cur)
            cur = []
    return stages[:first], chunks


def prove_transfer(device, budget: int | None = BUDGET) -> dict:
    """The transfer proved on `device` (torch.device; "cpu" for tests) by
    evm.prove_state_test, which raises unless the last chunk's mem_out* is
    the post-state image's digest and its accounts agree with the host
    model's and the file's postState; the chain, the accounts against the
    file's postState, each chunk's zkin sha256 and the machine's committed
    width (the LDE's and the leaves' columns)."""
    import torch

    from . import kernels
    from .stark.serializer import stark_proof_to_dict
    from .utils.profiler import Prof
    from .zkvm import evm
    from .zkvm.rv32_lib import check_chain_publics

    cuda = torch.device(device).type == "cuda"
    prof = Prof("guests", torch.device(device), on=True)
    if cuda:
        torch.cuda.synchronize(device)
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = evm.prove_state_test(STATE, n_bits=NBITS, n_queries=QUERIES,
                               rows_budget=budget, device=device, prof=prof)
    if cuda:
        torch.cuda.synchronize(device)
    prove_s = time.perf_counter() - t0
    launches = kernels.counts()
    setup, chunks = _split(prof.stages)
    expected = evm.load_state_test(STATE)[3]
    digests = [hashlib.sha256(json.dumps(
        stark_proof_to_dict(p, "GL"), separators=(",", ":")).encode())
        .hexdigest() for p in res["proofs"]]
    return dict(prove_s=prove_s, launches=launches, setup=setup,
                setup_s=sum(sec for _, sec in setup), stages=chunks,
                n_chunks=res["n_chunks"], status=res["status"],
                gas_used=res["gas_used"], zkin_sha256=digests,
                width=res["setup"].starkinfo.map_sectionsN.get("cm1_2ns"),
                chain_holds=check_chain_publics(res["publics"]),
                post_ok=res["post"] == expected)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budget", type=int, default=BUDGET,
                    help="rows a chunk (0: one chunk)")
    ap.add_argument("--device", default=None,
                    help="cpu: prove on the CPU (the kernels' plain "
                         "versions); default: the card")
    args = ap.parse_args(argv)
    os.environ.setdefault("EIGEN_ZKVM_SYNC", "1")

    import torch

    from . import kernels
    from .utils.devices import card_line, cuda_device

    if args.device == "cpu":
        dev = torch.device("cpu")
        report = {"card": None, "threads": torch.get_num_threads()}
    else:
        dev = cuda_device(0)
        report = {"card": card_line()}
        print(f"card: {report['card']}", flush=True)
        report["build_s"] = kernels.load(GL_SOURCES)["seconds"]
    report["elfs"] = run_elfs()
    for r in report["elfs"]:
        print(f"{r['name']}: {r['cycles']} cycles, a0 {r['a0']} (oracle "
              f"{r['want']}) in {r['s']:.3f} s", flush=True)
    r = prove_transfer(dev, budget=args.budget or None)
    report["transfer"] = r
    print(f"transfer: setup {r['setup_s']:.3f} s "
          + str([(st, round(sec, 3)) for st, sec in r["setup"]]), flush=True)
    for k, stages in enumerate(r["stages"]):
        print(f"chunk {k}: {sum(sec for _, sec in stages):.3f} s "
              + str([(st, round(sec, 3)) for st, sec in stages])
              + f"; zkin sha256 {r['zkin_sha256'][k]}", flush=True)
    print(f"prove {r['prove_s']:.3f} s; chain {r['chain_holds']}, post-state "
          f"{r['post_ok']}; launches {r['launches']}", flush=True)
    print(json.dumps(report))
    ok = all(e["ok"] for e in report["elfs"]) and r["chain_holds"] \
        and r["post_ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
