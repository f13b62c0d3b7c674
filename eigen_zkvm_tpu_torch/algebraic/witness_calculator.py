"""Circom-2 WASM witness calculator over the native interpreter.

Mirrors the reference's wasmer-backed flow
(algebraic/src/witness/witness_calculator.rs:114 calculate_witness_circom:
init -> fnv-keyed setInputSignal per input element -> getWitness /
readSharedRWMemory), so externally-compiled circom circuits (.wasm) can
have their witnesses computed here without any wasm runtime dependency.

    wc = WitnessCalculator.from_file("mycircuit.wasm")
    wtns = wc.calculate_witness({"a": [3], "b": [11]})   # list[int]
    wc.save_wtns("out.wtns", wtns)

Copy of eigen_zkvm_tpu/algebraic/witness_calculator.py on the port's
algebraic/wasmvm.py and algebraic/witness.py (the same .wtns bytes).
"""
from __future__ import annotations

from .wasmvm import Instance, Trap, WasmModule
from .witness import witness_to_bytes


def fnv64(s: str) -> tuple[int, int]:
    """FNV-1a 64-bit of the signal name (reference witness/mod.rs:15)."""
    h = 0xCBF29CE484222325
    for c in s.encode():
        h ^= c
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h >> 32, h & 0xFFFFFFFF


class WitnessCalculator:
    def __init__(self, module: WasmModule):
        self._msg_chars: list[int] = []
        self._error: str | None = None
        imports = {"runtime": {
            "exceptionHandler": self._exception,
            "printErrorMessage": self._print_error,
            "writeBufferMessage": self._write_buffer,
            "showSharedRWMemory": self._show_memory,
            # circom-1 era callbacks, present in some modules
            "error": self._legacy_error,
            "log": lambda *a: None,
            "logSetSignal": lambda *a: None,
            "logGetSignal": lambda *a: None,
            "logFinishComponent": lambda *a: None,
            "logStartComponent": lambda *a: None,
        }}
        self.inst = Instance(module, imports)
        self.n32 = self.inst.invoke("getFieldNumLen32")
        self.inst.invoke("getRawPrime")
        self.prime = self._read_fr()
        self.version = self.inst.invoke("getVersion")

    @classmethod
    def from_file(cls, path: str) -> "WitnessCalculator":
        with open(path, "rb") as f:
            return cls(WasmModule(f.read()))

    # -- runtime callbacks --
    def _read_message(self) -> str:
        chars = []
        while True:
            c = self.inst.invoke("getMessageChar")
            if not c:
                break
            chars.append(chr(c & 0xFF))
        return "".join(chars)

    def _exception(self, code=0):
        errs = {1: "signal not found", 2: "too many signals set",
                3: "signal already set", 4: "assert failed",
                5: "not enough signals set"}
        msg = errs.get(code, f"error code {code}")
        if self._error:
            msg = f"{msg}: {self._error}"
        raise Trap(f"circom runtime exception: {msg}")

    def _print_error(self):
        self._error = self._read_message()

    def _write_buffer(self):
        self._read_message()  # drained; log-style messages are dropped

    def _show_memory(self):
        pass

    def _legacy_error(self, code=0, *a):
        raise Trap(f"circom runtime error {code}")

    # -- shared-memory field IO --
    def _read_fr(self) -> int:
        v = 0
        for j in range(self.n32):
            v |= self.inst.invoke("readSharedRWMemory", j) << (32 * j)
        return v

    def _write_fr(self, v: int):
        for j in range(self.n32):
            self.inst.invoke("writeSharedRWMemory", j,
                             (v >> (32 * j)) & 0xFFFFFFFF)

    # -- public API --
    def calculate_witness(self, inputs: dict, sanity_check: bool = False):
        """inputs: name -> int | list[int] (flattened array signals).
        Returns the full witness as list[int] (index 0 is the constant 1)."""
        self.inst.invoke("init", 1 if sanity_check else 0)
        for name, values in inputs.items():
            if isinstance(values, (int, str)):
                values = [values]
            msb, lsb = fnv64(name)
            for i, value in enumerate(values):
                self._write_fr(int(value) % self.prime)
                self.inst.invoke("setInputSignal", msb, lsb, i)
        n = self.inst.invoke("getWitnessSize")
        out = []
        for i in range(n):
            self.inst.invoke("getWitness", i)
            out.append(self._read_fr())
        return out

    def save_wtns(self, path: str, witness: list[int]):
        """snarkjs-compatible .wtns (witness.py layout)."""
        with open(path, "wb") as f:
            f.write(witness_to_bytes(witness, self.prime))
