"""Kernel 5, the IK kernel (``arm_ik_prepare_kernel`` in
``furniture_tpu_torch/physics/csrc/arm_ik.cu``): the IK target's update and
the 20-iteration DLS IK of every env and arm of an ik control step, one
launch a step.

Only the name its device time is read by (``readers/kernel_time.py``, the
metric ``kernel5_ms.step``). There is no work count: one env's chain of
dependent steps bounds the kernel, not its operations or bytes (about 13
MFLOP at Sawyer's B = 256, ~0.2 us at the FP32 peak), so a share of its
roofline would read ~0.1% and the benchmark reports none.
"""

PATTERN = "arm_ik_prepare_kernel"
