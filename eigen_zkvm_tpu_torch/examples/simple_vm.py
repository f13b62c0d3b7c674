"""Simple-VM AIR example — the starkjs `simple_vm` family (reference
starkjs/simple_vm/simple_vm.pil: a register VM with a ROM lookup and a
conditional-jump PC relation).

Here the VM is the repo's MiniRV machine at toy size (the round-2 survey
note: simple_vm is superseded by the real zkVM machines; this example
wraps it in the same (pil, const_pols, make_trace) shape as the other
examples so the starkjs example set is complete).  The demo program is
the reference simple_vm's spirit: a loop that folds an input tape into
two registers with a data-dependent branch.

Copy of eigen_zkvm_tpu/examples/simple_vm.py on the port's zkvm/isa.py and
zkvm/machine.py.  build(n_bits) -> (pil, const_pols, make_trace,
reference, machine)."""
from __future__ import annotations

from ..zkvm.isa import assemble, execute
from ..zkvm.machine import MiniRVMachine

# fold the tape: acc += x if x < 100 else acc += 1; cnt counts big values
PROGRAM = """
    in   x1          # n
    li   x2, 0       # acc
    li   x3, 0       # cnt
    li   x4, 0       # i
    li   x5, 1
    li   x6, 100
loop:
    beq  x4, x1, done
    in   x7
    blt  x7, x6, small
    add  x3, x3, x5
    add  x2, x2, x5
    j    next
small:
    add  x2, x2, x7
next:
    add  x4, x4, x5
    j    loop
done:
    halt
"""


def build(n_bits: int = 10):
    program = assemble(PROGRAM)
    machine = MiniRVMachine(program, n_bits)

    def make_trace(inputs):
        machine.set_tape(list(inputs))  # tape is a constant column
        states = execute(program, list(inputs))
        if isinstance(states, tuple):
            states = states[0]
        return machine.trace(states, inputs=list(inputs))

    def reference(inputs):
        n, xs = inputs[0], inputs[1:]
        acc = cnt = 0
        for x in xs[:n]:
            if x < 100:
                acc = (acc + x) & 0xFFFFFFFF
            else:
                cnt += 1
                acc = (acc + 1) & 0xFFFFFFFF
        return acc, cnt

    return machine.pil, machine.const_pols, make_trace, reference, machine
