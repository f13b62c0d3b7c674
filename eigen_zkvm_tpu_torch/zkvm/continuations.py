"""Memory-continuation machinery shared by the zkVM machines
(MiniRVMachine and Rv32Machine): RAM image tables, the absorb shift
register, the Poseidon-GL coprocessor pipeline, capacity/digest chains and
digest publics.  See zkvm/machine.py for the design notes.
(reference: zkvm/src/lib.rs:215-223,319-365 powdr bootloader hashing)

The host machine object must provide: p (PilBuilder), N, ram_words,
s_on/s_addr/s_val/m_addr column ids, _im_same/_is_mem stashed expressions,
and receives the c_*/m_* continuation column ids as attributes.

Copy of eigen_zkvm_tpu/zkvm/continuations.py for the PyTorch port, with
its own copy of the round constants and MDS of the coprocessor's
permutation (`_poseidon_tables`, from data/cposeidon_gl.npy and
data/poseidon_gl_opt.npz).
"""
from __future__ import annotations

import os

import numpy as np

from ..ops import gl

P = gl.P_INT
_CPOSEIDON = None
_MDS = None

# one permutation block = 8 absorb rows | init row | 30 round-transition
# rows; the final state row doubles as the last transition's target
_PBLK = 39
_PABS = 8          # absorb rows per block (sponge rate)
_PROUNDS = 30


def _poseidon_tables():
    """(round constants [30][12], MDS [12][12]) of the non-opt Poseidon-GL
    permutation, as Python ints: out[i] = sum_j MDS[i][j] * in[j]."""
    global _CPOSEIDON, _MDS
    if _CPOSEIDON is None:
        d = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data")
        _CPOSEIDON = [[int(x) for x in row]
                      for row in np.load(os.path.join(d, "cposeidon_gl.npy"))]
        m = np.load(os.path.join(d, "poseidon_gl_opt.npz"))["M"]
        _MDS = [[int(m[j][i]) for j in range(12)] for i in range(12)]
    return _CPOSEIDON, _MDS


def _pos_round(state, j):
    """One non-opt Poseidon-GL round (the POSEIDON12 gate's round function,
    recursion/circuit.py poseidon): s1 = st + CP[j]; sbox lane 0 always,
    all lanes on full rounds; out = MDS * s."""
    CP, MDS = _poseidon_tables()
    s1 = [(state[i] + CP[j][i]) % P for i in range(12)]
    partial = 4 <= j < 26
    sr = [pow(s1[0], 7, P)] + [
        s1[i] if partial else pow(s1[i], 7, P) for i in range(1, 12)]
    return [sum(MDS[i][k] * sr[k] for k in range(12)) % P
            for i in range(12)]


def ram_digest(words):
    """Host-side image digest, bit-identical to the in-trace coprocessor:
    rate-8 sponge of non-opt Poseidon permutations, capacity chained from
    the previous block's output lanes 0..3; digest = final lanes 0..3."""
    words = [int(w) for w in words]
    assert len(words) % _PABS == 0
    cap = [0, 0, 0, 0]
    for k in range(0, len(words), _PABS):
        st = words[k : k + _PABS] + cap
        for j in range(_PROUNDS):
            st = _pos_round(st, j)
        cap = st[:4]
    return cap


def rows_needed(ram_words: int) -> int:
    """Coprocessor rows for a full in+out image hash."""
    return 2 * (ram_words // _PABS) * _PBLK


def declare_consts(m, p):
    """Coprocessor schedule + image table constant columns."""
    m.c_img_addr = p.const_pol(f"{m.NS}.IMG_ADDR")
    m.c_img1_on = p.const_pol(f"{m.NS}.IMG1_ON")
    m.c_img2_on = p.const_pol(f"{m.NS}.IMG2_ON")
    m.c_pos_rc = p.const_pol(f"{m.NS}.POS_RC", 12)
    m.c_pos_full_on = p.const_pol(f"{m.NS}.POS_FULL_ON")
    m.c_pos_part_on = p.const_pol(f"{m.NS}.POS_PART_ON")
    m.c_pinit_chain = p.const_pol(f"{m.NS}.PINIT_CHAIN")
    m.c_pcap0 = p.const_pol(f"{m.NS}.PCAP0")
    m.c_pinit = p.const_pol(f"{m.NS}.PINIT")
    m.c_nl_pend = p.const_pol(f"{m.NS}.NL_PEND")
    m.c_nl_npend = p.const_pol(f"{m.NS}.NL_NPEND")
    m.c_nl_dig = p.const_pol(f"{m.NS}.NL_DIG")
    m.c_nl_ndig = p.const_pol(f"{m.NS}.NL_NDIG")


def declare_commits(m, p):
    m.m_img_w = p.cm_pol(f"{m.NS}.img_w")        # absorb stream
    m.m_img_out = p.cm_pol(f"{m.NS}.img_out")    # table on IMG1 rows
    m.m_touched = p.cm_pol(f"{m.NS}.touched")
    m.m_buf = p.cm_pol(f"{m.NS}.pbuf", _PABS)    # absorb shift reg
    m.m_pst = p.cm_pol(f"{m.NS}.pst", 12)        # poseidon state
    m.m_cap = p.cm_pol(f"{m.NS}.pcap", 4)        # running capacity
    m.m_dcap = p.cm_pol(f"{m.NS}.pdig", 4)       # digest_in capture


def build(self, p, not_last, llast):
    """Image table, absorb shift register, Poseidon round pipeline,
    capacity chain and digest publics.  Every identity stays <= degree 2
    (constant-product gates are precomputed constant columns)."""
    _, MDS = _poseidon_tables()
    cm, const, num = p.cm, p.const, p.num
    img1, img2 = const(self.c_img1_on), const(self.c_img2_on)
    img_addr = const(self.c_img_addr)
    img_w = cm(self.m_img_w)
    img_out = cm(self.m_img_out)
    touched = cm(self.m_touched)
    s_on = cm(self.s_on)

    # image-2 absorb rows carry exactly the outgoing image table
    # (per-address bijection: addresses are unique on both sides)
    p.permutation(f=[img_addr, img_w], t=[img_addr, img_out],
                  sel_f=img2, sel_t=img1, file_name="zkvm.pil", line=50)

    # touched is boolean, only on image-1 rows; untouched addresses copy
    # the incoming word to the outgoing image
    p.identity(p.mul(touched, p.sub(num(1), touched)), "zkvm.pil", 51)
    p.identity(p.mul(p.sub(num(1), img1), touched), "zkvm.pil", 52)
    im_untouched = p.intermediate(
        p.mul(p.sub(num(1), touched), p.sub(img_out, img_w)))
    p.identity(p.mul(img1, im_untouched), "zkvm.pil", 53)

    # every address segment's final value lands in the outgoing image at
    # a touched slot (exact bijection), and the sorted side may not use
    # the wrap row
    im_end = p.sub(s_on, self._im_same)
    p.identity(p.mul(llast, s_on), "zkvm.pil", 54)
    p.permutation(f=[cm(self.s_addr), cm(self.s_val)],
                  t=[img_addr, img_out],
                  sel_f=im_end, sel_t=touched,
                  file_name="zkvm.pil", line=55)

    # all accessed addresses live inside the image
    p.plookup(f=[cm(self.m_addr)], t=[img_addr],
              sel_f=self._is_mem, sel_t=img1,
              file_name="zkvm.pil", line=56)

    # absorb shift register: buf_l[r] = img_w[r - 1 - l]
    buf = [cm(self.m_buf + l) for l in range(_PABS)]
    bufp = [cm(self.m_buf + l, True) for l in range(_PABS)]
    p.identity(p.mul(not_last, p.sub(bufp[0], img_w)), "zkvm.pil", 57)
    for l in range(1, _PABS):
        p.identity(p.mul(not_last, p.sub(bufp[l], buf[l - 1])),
                   "zkvm.pil", 57)

    st = [cm(self.m_pst + i) for i in range(12)]
    stp = [cm(self.m_pst + i, True) for i in range(12)]
    cap = [cm(self.m_cap + j) for j in range(4)]
    capp = [cm(self.m_cap + j, True) for j in range(4)]
    dcap = [cm(self.m_dcap + j) for j in range(4)]
    dcapp = [cm(self.m_dcap + j, True) for j in range(4)]

    # init row: rate lanes from the shift register, capacity chained
    # from the previous block (zeroed at each image start via PCAP0)
    pinit = const(self.c_pinit)
    for l in range(_PABS):
        p.identity(p.mul(pinit, p.sub(st[l], buf[_PABS - 1 - l])),
                   "zkvm.pil", 58)
    for j in range(4):
        p.identity(p.mul(const(self.c_pinit_chain),
                         p.sub(st[8 + j], cap[j])), "zkvm.pil", 59)
        p.identity(p.mul(const(self.c_pcap0), st[8 + j]),
                   "zkvm.pil", 60)

    # round transitions: st' = MDS * sbox(st + RC), sbox on lane 0
    # always, all lanes on full rounds; x^7 via chained intermediates
    rc = [const(self.c_pos_rc + i) for i in range(12)]
    s1 = [p.add(st[i], rc[i]) for i in range(12)]
    a7 = []
    for i in range(12):
        a2 = p.intermediate(p.mul(s1[i], s1[i]))
        a4 = p.intermediate(p.mul(a2, a2))
        a6 = p.intermediate(p.mul(a4, a2))
        a7.append(p.intermediate(p.mul(a6, s1[i])))
    for i in range(12):
        full_sum = p.lin([(MDS[i][k], a7[k]) for k in range(12)])
        p.identity(p.mul(const(self.c_pos_full_on),
                         p.sub(stp[i], full_sum)), "zkvm.pil", 61)
        part_sum = p.lin([(MDS[i][0], a7[0])]
                         + [(MDS[i][k], s1[k]) for k in range(1, 12)])
        p.identity(p.mul(const(self.c_pos_part_on),
                         p.sub(stp[i], part_sum)), "zkvm.pil", 62)

    # capacity / digest_in hold-or-capture chains
    for j in range(4):
        p.identity(p.add(p.mul(const(self.c_nl_npend),
                               p.sub(capp[j], cap[j])),
                         p.mul(const(self.c_nl_pend),
                               p.sub(capp[j], st[j]))), "zkvm.pil", 63)
        p.identity(p.add(p.mul(const(self.c_nl_ndig),
                               p.sub(dcapp[j], dcap[j])),
                         p.mul(const(self.c_nl_dig),
                               p.sub(dcapp[j], st[j]))), "zkvm.pil", 64)

    # digest publics: incoming/outgoing image digests at the last row
    for j in range(4):
        pub_in = p.public_input(f"mem_in{j}", dcap[j], self.N - 1)
        p.identity(p.mul(llast, p.sub(dcap[j], pub_in)), "zkvm.pil", 65)
        pub_out = p.public_input(f"mem_out{j}", cap[j], self.N - 1)
        p.identity(p.mul(llast, p.sub(cap[j], pub_out)), "zkvm.pil", 66)


def fill_trace(self, buf, mem_ops, image_in):
    """Image tables, absorb shift register, Poseidon pipeline states,
    capacity/digest chains."""
    N, M = self.N, self.ram_words
    nblk = M // _PABS
    img_in = [int(w) for w in image_in]
    img_out = list(img_in)
    touched = set()
    for addr, step, val, iswr in sorted(mem_ops, key=lambda o: o[1]):
        assert addr < M, f"address {addr} outside the RAM image"
        touched.add(addr)
        if iswr:
            img_out[addr] = val

    # absorb stream + image tables
    for img_idx, words in ((0, img_in), (1, img_out)):
        for k in range(nblk):
            base = (img_idx * nblk + k) * _PBLK
            for l in range(_PABS):
                buf[base + l, self.m_img_w] = words[_PABS * k + l]
    for k in range(nblk):
        base = k * _PBLK
        for l in range(_PABS):
            a = _PABS * k + l
            buf[base + l, self.m_img_out] = img_out[a]
            buf[base + l, self.m_touched] = 1 if a in touched else 0

    # shift register: buf_l[r] = img_w[r - 1 - l]
    col = buf[:, self.m_img_w]
    for l in range(_PABS):
        buf[l + 1 :, self.m_buf + l] = col[: N - 1 - l]

    # Poseidon pipelines + capacity/digest chains
    cap = [0, 0, 0, 0]
    dig_in = None
    cap_col = np.zeros((N, 4), dtype=np.uint64)
    dcap_col = np.zeros((N, 4), dtype=np.uint64)
    for img_idx, words in ((0, img_in), (1, img_out)):
        if img_idx == 1:
            cap = [0, 0, 0, 0]
        for k in range(nblk):
            base = (img_idx * nblk + k) * _PBLK
            init = base + _PABS
            st = words[_PABS * k : _PABS * (k + 1)] + \
                ([0, 0, 0, 0] if k == 0 else cap)
            for i in range(12):
                buf[init, self.m_pst + i] = st[i]
            for j in range(_PROUNDS):
                st = _pos_round(st, j)
                for i in range(12):
                    buf[init + j + 1, self.m_pst + i] = st[i]
            cap = st[:4]
            # capture lands on the row after the block end
            cap_col[init + _PROUNDS + 1 :] = cap
        if img_idx == 0:
            dig_in = cap
            dcap_col[(nblk - 1) * _PBLK + _PABS + _PROUNDS + 1 :] = dig_in
    buf[:, self.m_cap : self.m_cap + 4] = cap_col
    buf[:, self.m_dcap : self.m_dcap + 4] = dcap_col
    self._last_digests = (dig_in, cap)

def fill_sorted_mem(self, buf, mem_ops):
    """Address/step-sorted RAM columns + helper witnesses."""
    assert len(mem_ops) <= self.N - 1, "too many memory ops for chunk"
    ops = sorted(mem_ops)  # by (addr, step)
    P_INT = gl.P_INT
    for i, (addr, step, val, iswr) in enumerate(ops):
        buf[i, self.s_on] = 1
        buf[i, self.s_addr] = addr
        buf[i, self.s_step] = step
        buf[i, self.s_val] = val
        buf[i, self.s_iswr] = iswr
    for i in range(len(ops)):
        # helpers live on row i and describe the i -> i+1 transition
        if i + 1 < len(ops):
            a0, s0 = ops[i][0], ops[i][1]
            a1, s1 = ops[i + 1][0], ops[i + 1][1]
            d = (a1 - a0) % P_INT
            if d == 0:
                buf[i, self.s_same] = 1
                sd = s1 - s0 - 1
                buf[i, self.s_bytes_sd] = sd & 0xFF
                buf[i, self.s_bytes_sd + 1] = (sd >> 8) & 0xFF
            else:
                buf[i, self.s_dinv] = pow(d, P_INT - 2, P_INT)
                ad = a1 - a0 - 1
                for k in range(4):
                    buf[i, self.s_bytes_ad + k] = (ad >> (8 * k)) & 0xFF
