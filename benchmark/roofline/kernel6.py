"""Kernel 6, the connect kernel (``connect_step_kernel`` in
``furniture_tpu_torch/physics/csrc/assembly.cu``): the connect attempt of
every env of a step (the alignment search over the connector pairs, then
the interpolation or the snap with its floor lift, weld and group merge, an
arm's snap-back move with it), and the cursor's snap-back move, one launch
each a step.

Only the name its device time is read by (``readers/kernel_time.py``, the
metric ``kernel6_ms.step``). There is no work count: one env's chain of
dependent steps bounds the kernel, not its operations or bytes (at most a
few kFLOP and ~0.5 kB an env, ~2 MB at the cursor's B = 4096, under 1 us at
the card's FP32 peak and bandwidth), so a share of its roofline would read
near 0 and the benchmark reports none.
"""

PATTERN = "connect_step_kernel"
