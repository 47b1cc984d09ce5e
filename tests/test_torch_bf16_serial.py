"""A bfloat16 request through both packages' serial Runners (the CI
checkpoint on test_torch_runner.py's 48^3 phantom), held as
test_torch_bf16.py's 8-lane case; a file of its own because the JAX
package's serial run is the slowest case.
"""

import torch

from test_torch_bf16 import check_bf16_runner

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)


def test_bf16_serial_runner_matches_jax_runner(tmp_path):
    check_bf16_runner(tmp_path, 1)
