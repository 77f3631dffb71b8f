"""Tests that need the card: the lattice at real widths against the
float64 reference, on the GPU, at the gateway's precisions.  They skip
without a GPU; run them with ``JAX_PLATFORMS=cuda python -m pytest
tests/ -m gpu``."""

import pytest

import chip_smoke
from gr_lora_tpu.dist.collision_gateway import DEFAULT_BACKEND


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "default", "bf16"])
@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
def test_gpu_lattice_matches_reference(gpu, sf, precision):
    chip_smoke.phase_lattice(DEFAULT_BACKEND, precisions=(precision,),
                             sfs=(sf,))
