"""A bfloat16 request through both packages' serial Runners.

The serial Canvas (concurrent_requests unset) with the CI checkpoint in
bfloat16 on the 48^3 phantom of test_torch_runner.py, held as
test_torch_bf16.py's 8-lane case is (check_bf16_runner). A file of its
own: under parallel test workers, which take a file each, the JAX
package's step-by-step serial run is the slowest case of the two.
"""

import torch

from test_torch_bf16 import check_bf16_runner

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)


def test_bf16_serial_runner_matches_jax_runner(tmp_path):
    check_bf16_runner(tmp_path, 1)
