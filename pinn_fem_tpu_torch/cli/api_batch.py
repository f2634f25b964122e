"""Batched-solve JSON API (counterpart of pinn_fem_tpu/cli/api_batch.py).

    python -m pinn_fem_tpu_torch.cli.api_batch input.json output.json

Input/output contract: parallel/batched.solve_batch_request, a template
problem (generic schema) plus a (B, ndof) loads_batch, solved as one batch
({batch, converged, iterations, displacements}).  The Node backend's
/solve-batch route spawns the JAX package's CLI of the same contract.
On error {error, type} and exit 1, as the other api_* CLIs;
PINN_FEM_TORCH_DEVICE picks the device (default "cuda").
"""

from __future__ import annotations

import sys

from ._api_common import api_main


def parse_and_solve(input_data, device=None):
    from ..parallel.batched import solve_batch_request

    return solve_batch_request(input_data, device=device)


def main(argv=None) -> int:
    return api_main(
        parse_and_solve, argv,
        usage="Usage: python -m pinn_fem_tpu_torch.cli.api_batch "
              "input.json output.json")


if __name__ == "__main__":
    sys.exit(main())
