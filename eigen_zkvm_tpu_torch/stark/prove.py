"""File-based prove entry of the port: load, setup, prove, self-verify.

Port of eigen_zkvm_tpu/stark/prove.py::stark_prove: PIL JSON + starkStruct
JSON + .const/.cm files in, a self-verified proof (and its zkin JSON) out,
proved on `device` (None: the current CUDA device).
"""
from __future__ import annotations

import torch

from ..utils.profiler import Prof
from .engine import Engine
from .polsarray import PolsArray
from .serializer import stark_proof_to_json
from .stark_gen import stark_gen
from .stark_setup import StarkSetup
from .stark_verify import stark_verify
from .types import load_pil, load_starkstruct


def stark_prove(stark_struct_file: str, pil_file: str, const_file: str,
                cm_file: str, zkin_out: str | None = None,
                prover_addr: str = "",
                device: torch.device | str | None = None,
                prof: Prof | None = None):
    """Prove one PIL trace; returns (proof, setup).  Writes the zkin JSON
    to `zkin_out` when given; `prof` receives stark_gen's stage ticks."""
    engine = Engine(device)
    pil = load_pil(pil_file)
    ss = load_starkstruct(stark_struct_file)
    const_pols = PolsArray(pil, PolsArray.CONSTANT).load(const_file)
    cm_pols = PolsArray(pil, PolsArray.COMMIT).load(cm_file)
    setup = StarkSetup(const_pols, pil, ss, engine)
    proof = stark_gen(cm_pols, const_pols, setup.const_tree, setup.starkinfo,
                      setup.program, ss, engine=engine,
                      prover_addr=prover_addr, prof=prof)
    if not stark_verify(proof, setup.const_root, setup.starkinfo, ss,
                        setup.program):
        raise RuntimeError("generated proof failed self-verification")
    if zkin_out:
        with open(zkin_out, "w") as f:
            f.write(stark_proof_to_json(proof, ss.verificationHashType))
    return proof, setup
