"""STARK preprocessing on the port: const-pol LDE + Merkle tree + compile.

Port of eigen_zkvm_tpu/stark/stark_setup.py (starky stark_setup.rs: the
const root is the verification key), GL hash only.  The const tree is built
by ops/commit.py on the engine's device and stays there; the starkinfo
compiler is the port's copy (stark/starkinfo.py).
"""
from __future__ import annotations

import copy
import pickle

from ..ops import commit, gl
from .engine import Engine
from .starkinfo import Program, StarkInfo


class StarkSetup:
    def __init__(self, const_pols, pil, stark_struct,
                 engine: Engine | None = None, global_l1=None):
        if const_pols.nPols != pil.nConstants:
            raise ValueError("const pols do not match the PIL")
        if stark_struct.verificationHashType != "GL":
            raise NotImplementedError(
                f"verificationHashType {stark_struct.verificationHashType}")
        engine = engine or Engine()
        self.const_tree = commit.extend_and_merkelize(
            gl.from_u64(const_pols.buffer, engine.device), stark_struct.nBits,
            stark_struct.nBitsExt)
        self.const_root = self.const_tree.root()
        # the compiler mutates the PIL; keep the caller's reusable
        self.starkinfo = StarkInfo(copy.deepcopy(pil), stark_struct, global_l1)
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
