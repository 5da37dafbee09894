"""``repro_torch`` — the PyTorch/CUDA port of the Equilibrium planner.

A second package beside the JAX reference ``repro``: the cluster model,
the legality core, the host planners and the device-resident batch
engine, whose step selection is the hand-written Hopper kernel K1
(``csrc/masked_select.cu``).  It imports torch and NumPy, never JAX and
nothing of ``repro``.  Entry point: :func:`repro_torch.core.planner
.create_planner`.
"""
