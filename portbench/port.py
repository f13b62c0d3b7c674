"""The system under test: eigen_zkvm_tpu_torch's GL eSTARK prover, driven
through the entry that eigen_zkvm_tpu_torch/bench_chain.py drives
(StarkSetup once a circuit, then stark_gen on Engine(device) and the port's
serializer for each proof).  The only module of the benchmark that imports
the port."""
from __future__ import annotations

import time

import numpy as np
import torch

from eigen_zkvm_tpu_torch import kernels
from eigen_zkvm_tpu_torch.stark.engine import Engine
from eigen_zkvm_tpu_torch.stark.polsarray import PolsArray
from eigen_zkvm_tpu_torch.stark.serializer import stark_proof_to_json
from eigen_zkvm_tpu_torch.stark.stark_gen import stark_gen
from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup
from eigen_zkvm_tpu_torch.stark.types import PIL, StarkStruct
from eigen_zkvm_tpu_torch.utils.profiler import Prof

from .inputs import Circuit


class TickProf(Prof):
    """The prover's stage ticks, each with the wall clock (time.time_ns,
    the profiler's clock) at which it ended."""

    def __init__(self, device: torch.device):
        super().__init__("stark_gen", device, on=True)
        self.start_ns = time.time_ns()
        self.ends_ns: list[int] = []

    def tick(self, stage: str):
        super().tick(stage)
        self.ends_ns.append(time.time_ns())


# the kernel sources a GL eSTARK prove launches: the NTT and Poseidon-GL
SOURCES = ("ntt.cu", "poseidon_gl.cu")


def build_kernels(device: torch.device) -> list:
    """Build (or find built) and load the kernels of SOURCES alone; the
    sources it compiled."""
    if device.type != "cuda":
        return []
    return list(kernels.load(SOURCES)["compiled"])


class Prover:
    """One circuit set up on `device`: its const tree and starkinfo."""

    def __init__(self, c: Circuit, device: torch.device):
        self.circuit = c
        self.pil = PIL.from_json(c.pil_json)
        self.ss = StarkStruct.from_json(c.struct_json)
        self.device = device
        self.engine = Engine(device)
        self.const_pols = self._pols(PolsArray.CONSTANT, c.const)
        self.setup = StarkSetup(self.const_pols, self.pil, self.ss,
                                self.engine)

    def _pols(self, kind: str, buf: np.ndarray) -> PolsArray:
        pols = PolsArray(self.pil, kind)
        if buf.shape != pols.buffer.shape:
            raise ValueError(f"{kind} buffer {buf.shape}, the PIL wants "
                             f"{pols.buffer.shape}")
        pols.buffer = buf
        return pols

    def trace(self, buf: np.ndarray) -> PolsArray:
        """A host trace as the prover takes it."""
        return self._pols(PolsArray.COMMIT, buf)

    def prove(self, cm: PolsArray, prof: Prof | None = None) -> str:
        """One proof's JSON."""
        s = self.setup
        proof = stark_gen(cm, self.const_pols, s.const_tree, s.starkinfo,
                          s.program, self.ss, engine=self.engine, prof=prof)
        return stark_proof_to_json(proof, self.ss.verificationHashType)

    def close(self):
        """Free the device state (the const tree)."""
        self.setup = None
