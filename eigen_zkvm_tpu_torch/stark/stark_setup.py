"""STARK preprocessing on the port: const-pol LDE + Merkle tree + compile.

Port of eigen_zkvm_tpu/stark/stark_setup.py (starky stark_setup.rs: the
const root is the verification key).  The const tree is built by the hash
backend's tree builder (stark/backends.py: ops/commit.py for GL,
ops/commit_big.py for BN128 and BLS12381) on the engine's device and stays
there; the starkinfo compiler is the port's copy (stark/starkinfo.py).
A `prof` (utils/profiler.Prof) gets a tick after each of the two.
"""
from __future__ import annotations

import copy
import pickle

from ..ops import gl
from ..utils.profiler import Prof
from .backends import get_backend
from .engine import Engine
from .starkinfo import Program, StarkInfo


class StarkSetup:
    def __init__(self, const_pols, pil, stark_struct,
                 engine: Engine | None = None, global_l1=None,
                 prof: Prof | None = None):
        if const_pols.nPols != pil.nConstants:
            raise ValueError("const pols do not match the PIL")
        backend = get_backend(stark_struct.verificationHashType)
        engine = engine or Engine()
        self.const_tree = backend.tree.extend_and_merkelize(
            gl.from_u64(const_pols.buffer, engine.device), stark_struct.nBits,
            stark_struct.nBitsExt)
        self.const_root = self.const_tree.root()
        if prof:
            prof.tick("const tree")
        # the compiler mutates the PIL; keep the caller's reusable
        self.starkinfo = StarkInfo(copy.deepcopy(pil), stark_struct, global_l1)
        if prof:
            prof.tick("starkinfo compile")
        self.program: Program = self.starkinfo.program

    # checkpoint / resume: the setup is a reusable artifact
    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def load(path: str) -> "StarkSetup":
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if not isinstance(obj, StarkSetup):
            raise TypeError(f"{path} holds no StarkSetup")
        return obj
