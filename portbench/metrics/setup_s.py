"""setup_s (s, host clock): from process start to the window's opening:
imports, the kernel library, the circuit and its traces, the const tree
and starkinfo compile, and the warm-up proof."""


def read(run):
    return run.setup_s
