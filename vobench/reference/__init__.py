"""The plain reference of the benchmark: a frozen copy of the port's plain
PyTorch code (its CPU path: every hand kernel's plain version, each
``cond`` and ``while_loop`` read on the host), taken from
``stereo_vo_tpu_torch`` at the commit that added the benchmark, with its
imports pointed here and the CUDA wrappers, graph programs and launch
counts left out (where the copied docstrings speak of the card's kernels and
graphs, those parts are the port's, not here). It imports nothing of the
port, and a later change to the port does not change it. ``VOEngine``
(``engine/step.py``) runs on the CPU.

``tf32.py`` holds the control: the same reference with the inputs of every
matrix product rounded to TF32, the precision below the float32 with TF32
off that the configurations state.

``vobench/tests/test_vobench_dryrun.py`` holds the copy bitwise to the
port's CPU path.
"""
