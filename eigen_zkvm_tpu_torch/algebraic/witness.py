"""Witness file IO: snarkjs .wtns binary format and JSON witness lists, for
the port's command line.

Copy of eigen_zkvm_tpu/algebraic/witness.py (the native equivalent of
algebraic/src/reader.rs load_witness_from_* and the witness calculator's
output side); the bytes written and read are the same.  Computing a
witness (circom's WASM, the circuit builders) is not part of the port.
"""
from __future__ import annotations

import io
import json
import struct


def load_witness(path: str) -> list[int]:
    if path.endswith(".json"):
        with open(path) as f:
            return [int(x) for x in json.load(f)]
    with open(path, "rb") as f:
        return witness_from_bytes(f.read())


def witness_from_bytes(data: bytes) -> list[int]:
    r = io.BytesIO(data)
    if r.read(4) != b"wtns":
        raise ValueError("not a .wtns file: invalid magic")
    version, n_sections = struct.unpack("<II", r.read(8))
    if version > 2:
        raise ValueError(f".wtns version {version}, above 2")
    # section 1: header (field size + prime + count), section 2: values
    values = []
    fs = 32
    count = 0
    for _ in range(n_sections):
        stype, ssize = struct.unpack("<IQ", r.read(12))
        pos = r.tell()
        if stype == 1:
            (fs,) = struct.unpack("<I", r.read(4))
            r.read(fs)  # prime
            (count,) = struct.unpack("<I", r.read(4))
        elif stype == 2:
            for _ in range(count):
                values.append(int.from_bytes(r.read(fs), "little"))
        r.seek(pos + ssize)
    return values


def witness_to_bytes(values: list[int], prime: int) -> bytes:
    fs = 8 if prime < (1 << 64) else 32
    out = io.BytesIO()
    out.write(b"wtns")
    out.write(struct.pack("<II", 2, 2))
    header = struct.pack("<I", fs) + prime.to_bytes(fs, "little")
    header += struct.pack("<I", len(values))
    out.write(struct.pack("<IQ", 1, len(header)))
    out.write(header)
    body = b"".join((v % prime).to_bytes(fs, "little") for v in values)
    out.write(struct.pack("<IQ", 2, len(body)))
    out.write(body)
    return out.getvalue()


def save_witness(path: str, values: list[int], prime: int):
    if path.endswith(".json"):
        with open(path, "w") as f:
            json.dump([str(v) for v in values], f)
        return
    with open(path, "wb") as f:
        f.write(witness_to_bytes(values, prime))
