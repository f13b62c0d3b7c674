"""Binary .r1cs file reader/writer (circom format, with circom-2's custom
gates sections) for the port's command line.

Copy of eigen_zkvm_tpu/algebraic/r1cs_file.py (the native equivalent of
algebraic/src/r1cs_file.rs); `circuit_to_r1cs` takes the port's
recursion/circuit.py CircuitBuilder.  The bytes written and read are the
same.

Sections: 1 = header (field size, prime LE, nWires, nPubOut, nPubIn,
nPrvIn, nLabels, nConstraints), 2 = constraints (A,B,C sparse lcs),
3 = wire2label map, 4 = custom gates list, 5 = custom gates uses.

Constraints load as {wire: coef} dict triples, the R1CS convention of both
packages' Groth16; custom gates as (template_name, [signal ids]).
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

GL_PRIME = 0xFFFFFFFF00000001
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BLS12381_R = 52435875175126190479447740508185965837690552500527637822603658699938581184513

_HEADER, _CONSTRAINTS, _MAP, _CG_LIST, _CG_USE = 1, 2, 3, 4, 5


@dataclass
class R1CS:
    prime: int
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_labels: int
    constraints: list          # [(A, B, C) dicts]
    wire_map: list
    custom_gates: list = field(default_factory=list)   # (name, params)
    custom_gates_uses: list = field(default_factory=list)  # (id, [signals])

    @property
    def n_publics(self) -> int:
        return self.n_pub_out + self.n_pub_in


def _field_size(prime: int) -> int:
    return 8 if prime == GL_PRIME else 32


def load_r1cs(path: str) -> R1CS:
    with open(path, "rb") as f:
        data = f.read()
    return from_bytes(data)


def from_bytes(data: bytes) -> R1CS:
    r = io.BytesIO(data)
    if r.read(4) != b"r1cs":
        raise ValueError("not an .r1cs file: invalid magic")
    version, n_sections = struct.unpack("<II", r.read(8))
    if version != 1:
        raise ValueError(f".r1cs version {version}, not 1")
    sections = {}
    for _ in range(n_sections):
        stype, ssize = struct.unpack("<IQ", r.read(12))
        sections[stype] = (r.tell(), ssize)
        r.seek(ssize, 1)

    off, size = sections[_HEADER]
    r.seek(off)
    (fs,) = struct.unpack("<I", r.read(4))
    prime = int.from_bytes(r.read(fs), "little")
    n_wires, n_pub_out, n_pub_in, n_prv_in = struct.unpack("<IIII", r.read(16))
    (n_labels,) = struct.unpack("<Q", r.read(8))
    (n_constraints,) = struct.unpack("<I", r.read(4))

    def read_lc():
        (n,) = struct.unpack("<I", r.read(4))
        lc = {}
        for _ in range(n):
            (wire,) = struct.unpack("<I", r.read(4))
            coef = int.from_bytes(r.read(fs), "little")
            lc[wire] = coef
        return lc

    off, _ = sections[_CONSTRAINTS]
    r.seek(off)
    constraints = [(read_lc(), read_lc(), read_lc())
                   for _ in range(n_constraints)]

    wire_map = []
    if _MAP in sections:
        off, size = sections[_MAP]
        r.seek(off)
        wire_map = list(struct.unpack(f"<{n_wires}Q", r.read(8 * n_wires)))

    custom_gates = []
    custom_gates_uses = []
    if _CG_LIST in sections:
        off, _ = sections[_CG_LIST]
        r.seek(off)
        (num,) = struct.unpack("<I", r.read(4))
        for _ in range(num):
            name = b""
            while True:
                ch = r.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (n_params,) = struct.unpack("<I", r.read(4))
            params = [int.from_bytes(r.read(fs), "little")
                      for _ in range(n_params)]
            custom_gates.append((name.decode(), params))
    if _CG_USE in sections:
        off, size = sections[_CG_USE]
        r.seek(off)
        words = struct.unpack(f"<{size // 4}I", r.read(size))
        pos = 0
        n_uses = words[pos]
        pos += 1
        for _ in range(n_uses):
            gid = words[pos]
            pos += 1
            n_sig = words[pos]
            pos += 1
            sigs = []
            for _ in range(n_sig):
                lsb, msb = words[pos], words[pos + 1]
                pos += 2
                sigs.append(msb * 0x100000000 + lsb)
            custom_gates_uses.append((gid, sigs))

    return R1CS(prime=prime, n_wires=n_wires, n_pub_out=n_pub_out,
                n_pub_in=n_pub_in, n_prv_in=n_prv_in, n_labels=n_labels,
                constraints=constraints, wire_map=wire_map,
                custom_gates=custom_gates,
                custom_gates_uses=custom_gates_uses)


def to_bytes(r1cs: R1CS) -> bytes:
    fs = _field_size(r1cs.prime)
    out = io.BytesIO()
    out.write(b"r1cs")
    has_cg = bool(r1cs.custom_gates or r1cs.custom_gates_uses)
    n_sections = 3 + (2 if has_cg else 0)
    out.write(struct.pack("<II", 1, n_sections))

    def section(stype: int, payload: bytes):
        out.write(struct.pack("<IQ", stype, len(payload)))
        out.write(payload)

    header = struct.pack("<I", fs) + r1cs.prime.to_bytes(fs, "little")
    header += struct.pack("<IIII", r1cs.n_wires, r1cs.n_pub_out,
                          r1cs.n_pub_in, r1cs.n_prv_in)
    header += struct.pack("<Q", r1cs.n_labels or r1cs.n_wires)
    header += struct.pack("<I", len(r1cs.constraints))
    section(_HEADER, header)

    body = io.BytesIO()
    for A, B, C in r1cs.constraints:
        for lc in (A, B, C):
            body.write(struct.pack("<I", len(lc)))
            for wire in sorted(lc):
                body.write(struct.pack("<I", wire))
                body.write((lc[wire] % r1cs.prime).to_bytes(fs, "little"))
    section(_CONSTRAINTS, body.getvalue())

    wm = r1cs.wire_map or list(range(r1cs.n_wires))
    section(_MAP, struct.pack(f"<{len(wm)}Q", *wm))

    if has_cg:
        body = io.BytesIO()
        body.write(struct.pack("<I", len(r1cs.custom_gates)))
        for name, params in r1cs.custom_gates:
            body.write(name.encode() + b"\x00")
            body.write(struct.pack("<I", len(params)))
            for p in params:
                body.write((p % r1cs.prime).to_bytes(fs, "little"))
        section(_CG_LIST, body.getvalue())

        body = io.BytesIO()
        words = [len(r1cs.custom_gates_uses)]
        for gid, sigs in r1cs.custom_gates_uses:
            words.append(gid)
            words.append(len(sigs))
            for s in sigs:
                words.append(s & 0xFFFFFFFF)
                words.append(s >> 32)
        body.write(struct.pack(f"<{len(words)}I", *words))
        section(_CG_USE, body.getvalue())

    return out.getvalue()


def save_r1cs(path: str, r1cs: R1CS):
    with open(path, "wb") as f:
        f.write(to_bytes(r1cs))


def circuit_to_r1cs(circuit) -> R1CS:
    """Export a recursion.circuit.CircuitBuilder to the .r1cs schema
    (gate template names indexed in declaration order)."""
    # one gate definition per distinct (name, params) — circom convention
    # (FFT4 gates carry their 9 twiddle constants as template params)
    defs: list = []
    uses = []
    for entry in circuit.custom_gates:
        name, sigs = entry[0], entry[1]
        params = [int(c) for c in entry[2]] if len(entry) > 2 else []
        key = (name, tuple(params))
        if key not in defs:
            defs.append(key)
        uses.append((defs.index(key), sigs))
    return R1CS(
        prime=circuit.P, n_wires=circuit.n_vars, n_pub_out=0,
        n_pub_in=circuit.n_publics,
        n_prv_in=circuit.n_vars - circuit.n_publics - 1,
        n_labels=circuit.n_vars, constraints=list(circuit.constraints),
        wire_map=list(range(circuit.n_vars)),
        custom_gates=[(n, list(p)) for n, p in defs], custom_gates_uses=uses)


def r1cs_to_circuit_inputs(r1cs: R1CS):
    """(constraints, custom_gates named, n_vars, n_publics) for the
    compressor / groth16 entry points."""
    gates = []
    for gid, sigs in r1cs.custom_gates_uses:
        name, params = r1cs.custom_gates[gid]
        gates.append((name, sigs, tuple(int(p) for p in params))
                     if params else (name, sigs))
    return r1cs.constraints, gates, r1cs.n_wires, r1cs.n_publics
