"""File-based prove entry of the port: load, setup, prove, self-verify.

Port of eigen_zkvm_tpu/stark/prove.py::stark_prove: PIL JSON + starkStruct
JSON + .const/.cm files in, a self-verified proof (and its zkin JSON and
the circom text of its verifier, stark/pil2circom.py) out, proved on
`device` (None: the current CUDA device).
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
                circom_out: str | None = None, prover_addr: str = "",
                agg_stage: bool = False, norm_stage: bool = True,
                skip_main: bool = False,
                device: torch.device | str | None = None,
                prof: Prof | None = None):
    """Prove one PIL trace; returns (proof, setup).  Writes the zkin JSON
    to `zkin_out` and the verifier's circom text to `circom_out` when
    given (`norm_stage`: the const root is an input; `agg_stage`: a Main
    that verifies two proofs; `skip_main`: StarkVerifier is the main
    component); `prof` receives a "load + setup" tick, then stark_gen's
    stage ticks."""
    engine = Engine(device)
    pil = load_pil(pil_file)
    ss = load_starkstruct(stark_struct_file)
    const_pols = PolsArray(pil, PolsArray.CONSTANT).load(const_file)
    cm_pols = PolsArray(pil, PolsArray.COMMIT).load(cm_file)
    setup = StarkSetup(const_pols, pil, ss, engine)
    if prof:
        prof.tick("load + setup")
    proof = stark_gen(cm_pols, const_pols, setup.const_tree, setup.starkinfo,
                      setup.program, ss, engine=engine,
                      prover_addr=prover_addr, prof=prof)
    if not stark_verify(proof, setup.const_root, setup.starkinfo, ss,
                        setup.program):
        raise RuntimeError("generated proof failed self-verification")
    if zkin_out:
        with open(zkin_out, "w") as f:
            f.write(stark_proof_to_json(proof, ss.verificationHashType))
    if circom_out:
        from .pil2circom import StarkOption, pil2circom

        opt = StarkOption(enable_input=False, verkey_input=norm_stage,
                          skip_main=skip_main, agg_stage=agg_stage)
        with open(circom_out, "w") as f:
            f.write(pil2circom(pil, setup.const_root, ss, setup.starkinfo,
                               setup.program, opt))
    return proof, setup
