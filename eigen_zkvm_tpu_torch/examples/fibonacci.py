"""Fibonacci circuit — exact replica of the reference fixture's PIL
(starky/data/fib.pil.json.gl, authored from starkjs fibonacci_old.pil):

  pol constant ISLAST;
  pol commit aBeforeLast, aLast;
  public out = aLast(N-1);
  (1-ISLAST) * (aBeforeLast' - aLast) = 0;
  (1-ISLAST) * (aLast' - (aBeforeLast + aLast)) = 0;
  ISLAST * (aLast - :out) = 0;

Copy of eigen_zkvm_tpu/examples/fibonacci.py on the port's PilBuilder and
PolsArray; the additions on Python ints.  The small input of the recursion
layers' CPU tests.
"""
from __future__ import annotations

from ..ops import gl
from ..stark.pil_builder import PilBuilder
from ..stark.polsarray import PolsArray


def build(n_bits: int = 10):
    p = PilBuilder(n_bits)
    islast = p.const_pol("Fibonacci.ISLAST")
    a_before = p.cm_pol("Fibonacci.aBeforeLast")
    a_last = p.cm_pol("Fibonacci.aLast")
    N = 1 << n_bits

    out = p.public_input("out", p.cm(a_last), N - 1)
    one_m = p.sub(p.num(1), p.const(islast))
    p.identity(p.sub(p.mul(one_m, p.sub(p.cm(a_before, True), p.cm(a_last))),
                     p.num(0)), "fibonacci.pil", 6)
    p.identity(p.sub(p.mul(one_m, p.sub(p.cm(a_last, True),
                                        p.add(p.cm(a_before), p.cm(a_last)))),
                     p.num(0)), "fibonacci.pil", 7)
    p.identity(p.sub(p.mul(p.const(islast), p.sub(p.cm(a_last), out)),
                     p.num(0)), "fibonacci.pil", 10)
    pil = p.build()

    const_pols = PolsArray(pil, PolsArray.CONSTANT)
    const_pols.buffer[N - 1, islast] = 1

    def make_trace(inputs=(1, 2)):
        cm = PolsArray(pil, PolsArray.COMMIT)
        a, b = int(inputs[0]), int(inputs[1])
        for i in range(N):
            cm.buffer[i, a_before] = a
            cm.buffer[i, a_last] = b
            a, b = b, (a + b) % gl.P_INT
        return cm

    return pil, const_pols, make_trace
