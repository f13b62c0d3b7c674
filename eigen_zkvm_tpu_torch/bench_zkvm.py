"""zkVM chunk-proving benchmark of the port on one CUDA device.

    python -m eigen_zkvm_tpu_torch.bench_zkvm --chunks 0 1 --count --profile

The guest is the in-guest secp256k1 ecrecover (the ELF, gzip-compressed in
data/guests/ecrecover.elf.gz, built from zkvm/guest_secp256k1.py by the
port's C compiler, zkvm/cc.py: 15,642,943 cycles).  The native executor (zkvm/rv32_native.py) runs it
and splits it into 2^16-row continuation chunks (239); the RV32IM
machine's PIL and constants are built and set up once (StarkSetup on the
card, `zkvm.lib.default_struct(16, 4)`); then each chunk asked for is
traced, proved on the card and self-verified through
`zkvm.rv32_lib.rv32_prove_only`, its RAM-image digest publics are held to
`ram_digest` of its incoming and outgoing images, and the chunks asked for
must chain (`check_chain_publics`).  EIGEN_ZKVM_SYNC=1 (set here) drains
the device at every stage tick, so the stage walls are device walls.

Each chunk's stark_gen runs beside `nvidia-smi` sampling the card's
utilization.gpu every 100 ms (the share of each sample period in which a
kernel ran): its mean over the prove is the busy share, and the busy
share times the prove's wall the device time.  (A torch.profiler trace of
a whole chunk prove, millions of launches, did not finish in 30 minutes.)
With --profile, chunk `--chunks[0]` is proved once more under
torch.profiler (device activity only), read from its raw Kineto events
(`kernel_rows`): device time, launches by kind and name, and the busy
share, device time over stark_gen's wall (CUPTI's cost included).
With --count, chunk `--chunks[0]` is proved once more under `op_counter`,
which counts the operators dispatched during the prove (views excluded:
each other one launches about one kernel on the card): the eager
elementwise, sort and copy launches of the constraint VM, the plookup and
the FRI, beside the NTT and Poseidon kernels' own counts.

The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import sys
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
GUEST = os.path.join(_PKG, "data", "guests", "ecrecover.elf.gz")
NBITS, QUERIES = 16, 4
GUEST_CYCLES, GUEST_CHUNKS = 15_642_943, 239


def read_guest(path: str = GUEST) -> bytes:
    """The ELF's bytes from the fixture (gzip, or a plain ELF file)."""
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


class Guest:
    """A cc-built ELF loaded (zkvm.elf.load_c_elf) and run to its end by the
    native executor, split into chunks of 2^nbits rows."""

    def __init__(self, path: str = GUEST, nbits: int = NBITS):
        from .zkvm import rv32_native
        from .zkvm.elf import load_c_elf

        self.elf = read_guest(path)
        (self.program, self.entry, self.image0, self.ram_words,
         self.mem_base) = load_c_elf(self.elf)
        self.nbits = nbits
        t0 = time.perf_counter()
        self.chunker = rv32_native.NativeChunker(
            self.program, self.entry, n_bits=nbits,
            ram_words=self.ram_words, image0=self.image0,
            mem_base=self.mem_base)
        self.execute_s = time.perf_counter() - t0

    def image_out(self, k: int):
        """The RAM image at chunk k's end: the next chunk's incoming one,
        or the image after the halt."""
        chunks = self.chunker.chunks
        return chunks[k + 1].image_in if k + 1 < len(chunks) \
            else self.chunker.final_image

    def digests_hold(self, k: int, pubs: dict) -> bool:
        """Chunk k's mem_in*/mem_out* publics equal ram_digest of its
        incoming and outgoing images."""
        from .zkvm.continuations import ram_digest

        d_in = ram_digest(self.chunker.chunks[k].image_in)
        d_out = ram_digest(self.image_out(k))
        return all(pubs[f"mem_in{j}"] == d_in[j]
                   and pubs[f"mem_out{j}"] == d_out[j] for j in range(4))


def setup_machine(guest: Guest, queries: int, engine):
    """(machine, setup, ss, {"machine_s", "setup_s"}) for the guest's RV32IM
    machine at its chunk size; the setup's constant tree on the engine's
    device."""
    import torch

    from .stark.stark_setup import StarkSetup
    from .zkvm.lib import default_struct
    from .zkvm.rv32 import Rv32Machine

    t0 = time.perf_counter()
    machine = Rv32Machine(guest.program, guest.nbits,
                          ram_words=guest.ram_words, mem_base=guest.mem_base)
    t1 = time.perf_counter()
    ss = default_struct(guest.nbits, queries)
    setup = StarkSetup(machine.const_pols, machine.pil, ss, engine)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return machine, setup, ss, {"machine_s": t1 - t0,
                                "setup_s": time.perf_counter() - t1}


def prove_chunk(guest: Guest, machine, setup, ss, k: int, engine,
                busy: bool = False, keep_zkin: bool = False) -> dict:
    """Materialize, trace, prove and verify chunk k on the engine; the
    kernels' counts are set to 0 just before and read just after.  With
    `busy`, the card's utilization is sampled (GpuBusy) over the prove:
    `busy_share`, and `device_s`, that share of stark_gen's wall.  With
    `keep_zkin`, the proof's zkin dict is under "zkin" (the next recursion
    layer's input)."""
    import torch

    from . import kernels
    from .stark.serializer import stark_proof_to_dict
    from .utils.profiler import Prof
    from .zkvm.rv32_lib import rv32_prove_only

    t0 = time.perf_counter()
    states, image_in = guest.chunker.states_for(k)
    t1 = time.perf_counter()
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
    kernels.reset_counts()
    prof = Prof(f"chunk{k}", engine.device, on=True)
    sampler = GpuBusy(engine.device.index or 0) if busy else None
    if sampler:
        with sampler:
            proof, pubs = rv32_prove_only(machine, setup, ss, states,
                                          image_in, device=engine, prof=prof)
    else:
        proof, pubs = rv32_prove_only(machine, setup, ss, states, image_in,
                                      device=engine, prof=prof)
    if cuda:
        torch.cuda.synchronize(engine.device)
    launches = kernels.counts()
    t2 = time.perf_counter()
    zkin_dict = stark_proof_to_dict(proof, ss.verificationHashType)
    zkin = json.dumps(zkin_dict, separators=(",", ":"))  # stark_proof_to_json
    gen_s = sum(t for st, t in prof.stages if st not in ("trace", "verify"))
    out = dict(chunk=k, rows=len(states), states_s=t1 - t0,
               wall_s=t2 - t1, stark_gen_s=gen_s, stages=prof.stages,
               launches=launches, publics=pubs,
               digests_hold=guest.digests_hold(k, pubs),
               zkin_sha256=hashlib.sha256(zkin.encode()).hexdigest())
    if keep_zkin:
        out["zkin"] = zkin_dict
    if sampler:
        gen0 = prof.t0 + prof.stages[0][1]   # after the "trace" tick
        share, n = sampler.share(gen0, gen0 + gen_s)
        out.update(busy_share=share, busy_samples=n,
                   device_s=None if share is None else share * gen_s)
    return out


class GpuBusy:
    """`nvidia-smi` sampling utilization.gpu of one card every 100 ms while
    the context is open, each sample with its host time; the sampler is
    stopped on exit."""

    def __init__(self, index: int = 0):
        self.index = index
        self.samples: list[tuple[float, int]] = []

    def share(self, t0: float, t1: float):
        """Mean utilization of the samples taken between two host times,
        over 100, and their count; (None, 0) without one."""
        got = [v for t, v in self.samples if t0 <= t <= t1]
        return (sum(got) / len(got) / 100 if got else None), len(got)

    def __enter__(self):
        import subprocess
        import threading

        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", str(self.index),
             "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            if line.strip().isdigit():
                self.samples.append((time.perf_counter(), int(line)))

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except Exception:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)
        return False


def op_counter():
    """A TorchDispatchMode counting, by name, the operators dispatched while
    it is open, views excluded (`counts`); in a prove on the card each of
    them launches about one kernel.  It keeps its own cost per operator
    low: a name lookup and an add."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts: dict = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.counts[func] = self.counts.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

        def by_name(self) -> dict:
            out: dict[str, int] = {}
            for func, n in self.counts.items():
                name = func.overloadpacket.__name__
                out[name] = out.get(name, 0) + n
            return out

    return OpCounter()


def kernel_rows(tp) -> dict:
    """Device events of a finished torch.profiler run, read from its raw
    Kineto results (the profiler's own event objects are never built: at
    millions of launches that takes longer than the run): {"device_ms",
    "launches", "kinds" (the NTT and Poseidon kernels, memory copies and
    sets, every other kernel), "rows" ([name, ms, count], the 24
    longest)}."""
    from torch.autograd import DeviceType

    rows: dict[str, list] = {}
    for e in tp.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = rows.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    kinds = {k: {"launches": 0, "ms": 0.0}
             for k in ("ntt", "poseidon", "copy_set", "other")}
    for name, (ms, n) in rows.items():
        kind = ("ntt" if "ntt_leaf" in name else
                "poseidon" if "poseidon_gl" in name else
                "copy_set" if name.startswith(("Memcpy", "Memset")) else
                "other")
        kinds[kind]["launches"] += n
        kinds[kind]["ms"] += ms
    return {"device_ms": sum(ms for ms, _ in rows.values()),
            "launches": sum(n for _, n in rows.values()), "kinds": kinds,
            "rows": sorted(([k, ms, n] for k, (ms, n) in rows.items()),
                           key=lambda r: -r[1])[:24]}


def profile_chunk(guest: Guest, machine, setup, ss, k: int, engine) -> dict:
    """prove_chunk under torch.profiler (device activity only), with
    kernel_rows of the run under "profile" and its busy share: device
    time over stark_gen's wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        r = prove_chunk(guest, machine, setup, ss, k, engine)
    dt = kernel_rows(tp)
    del tp
    dt["busy_share"] = dt["device_ms"] / 1e3 / r["stark_gen_s"]
    r["profile"] = dt
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--count", action="store_true",
                    help="prove the first chunk once more under op_counter")
    ap.add_argument("--profile", action="store_true",
                    help="prove the first chunk once more under "
                         "torch.profiler")
    args = ap.parse_args(argv)
    os.environ.setdefault("EIGEN_ZKVM_SYNC", "1")

    import torch

    from . import kernels
    from .stark.engine import Engine
    from .utils.devices import card_line, cuda_device
    from .zkvm import rv32_native
    from .zkvm.rv32_lib import check_chain_publics

    dev = cuda_device(0)
    engine = Engine(dev)
    report = {"card": card_line(), "nbits": NBITS, "queries": QUERIES,
              "elf": os.path.basename(GUEST)}
    print(f"card: {report['card']}", flush=True)
    report["build_s"] = kernels.build()["seconds"]
    kernels.library()
    t0 = time.perf_counter()
    rv32_native.library()
    report["native_build_s"] = time.perf_counter() - t0

    guest = Guest()
    report.update(cycles=guest.chunker.total_cycles,
                  n_chunks=len(guest.chunker.chunks),
                  execute_s=guest.execute_s, ram_words=guest.ram_words,
                  mem_base=guest.mem_base)
    print(f"guest: {report['cycles']} cycles, {report['n_chunks']} chunks "
          f"of 2^{NBITS} rows, executed in {guest.execute_s:.3f} s",
          flush=True)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(dev)
    machine, setup, ss, times = setup_machine(guest, QUERIES, engine)
    report.update(times, n_cm=machine.pil.nCommitments,
                  n_const=machine.pil.nConstants)
    print(f"machine {times['machine_s']:.3f} s ({report['n_cm']} committed, "
          f"{report['n_const']} constant columns), setup "
          f"{times['setup_s']:.3f} s", flush=True)

    chunks = []
    for k in args.chunks:
        r = prove_chunk(guest, machine, setup, ss, k, engine, busy=True)
        chunks.append(r)
        print(f"chunk {k}: {r['rows']} states ({r['states_s']:.3f} s), "
              f"trace + prove + verify {r['wall_s']:.3f} s: "
              + " ".join(f"{s}={t:.3f}" for s, t in r["stages"])
              + f"; launches {r['launches']}; busy share {r['busy_share']} "
              f"({r['busy_samples']} samples), device {r['device_s']} s; "
              f"digests hold {r['digests_hold']}; zkin sha256 "
              f"{r['zkin_sha256']}", flush=True)
    report["chunks"] = chunks
    report["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    report["chain_holds"] = check_chain_publics([r["publics"]
                                                 for r in chunks])

    if args.count:
        counter = op_counter()
        with counter:
            r = prove_chunk(guest, machine, setup, ss, args.chunks[0],
                            engine)
        ops = sorted(counter.by_name().items(), key=lambda kv: -kv[1])
        report["counted"] = dict(
            chunk=r["chunk"], wall_s=r["wall_s"], stages=r["stages"],
            launches=r["launches"], ops=sum(counter.counts.values()),
            by_op=ops[:40], zkin_sha256=r["zkin_sha256"])
        print(f"chunk {r['chunk']} under the op counter: "
              f"{report['counted']['ops']} operators dispatched (views "
              f"excluded), wall {r['wall_s']:.3f} s; kernels "
              f"{r['launches']}; top: {ops[:12]}", flush=True)

    if args.profile:
        r = profile_chunk(guest, machine, setup, ss, args.chunks[0], engine)
        report["profiled"] = {k: r[k] for k in (
            "chunk", "wall_s", "stark_gen_s", "stages", "launches",
            "profile", "zkin_sha256")}
        dt = r["profile"]
        print(f"chunk {r['chunk']} under torch.profiler: stark_gen "
              f"{r['stark_gen_s']:.3f} s, device events {dt['device_ms']:.1f}"
              f" ms in {dt['launches']} launches (busy share "
              f"{dt['busy_share']:.4f}); by kind {dt['kinds']}", flush=True)
        for name, ms, n in dt["rows"][:16]:
            print(f"  {ms:10.3f} ms {n:8d}  {name[:70]}")

    report["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    print(f"peak device memory {report['peak_bytes'] / 2**30:.3f} GiB; "
          f"chain holds {report['chain_holds']}; JAX-package modules "
          f"loaded {report['foreign_modules']}")
    print(json.dumps(report), flush=True)
    ok = report["chain_holds"] and not report["foreign_modules"] and all(
        r["digests_hold"] for r in chunks)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
