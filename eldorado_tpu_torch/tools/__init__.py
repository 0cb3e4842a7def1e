"""Cost probes of K1 on the GPU, the counterparts of the repo's TPU tools.

Each module runs as ``python -m eldorado_tpu_torch.tools.<name>`` and needs
a CUDA device (there is no CPU mode):

- `step_cost`: K1 per step and K1-null per launch at 4096 envs
  (tools/tpu_true_step_cost.py);
- `null_kernel`: P1, the carry's copy floor (tools/tpu_null_kernel.py);
- `op_cost`: P2, the cost of one dependent int32 op (tools/tpu_op_cost.py);
- `prefix_profile`: P3, K1's per-step time split by cutting the step short
  (tools/tpu_prefix_profile.py).
"""
