"""The port's dry run of the five LM prefill_32k registry cells on both
production meshes (rank 0 of torch's fake process group of 256 and of 512
ranks), each record held to rank 0's shards summed independently, one
flash_attention launch a full-attention layer on the rank's block of
heads, its host reads, memory and replication
(``tests/torch_dryrun_lm_serve.py``; the MoE cells cut there)."""
import pytest

pytest.importorskip("torch")

import torch_dryrun_lm_serve as C  # noqa: E402


@pytest.fixture(scope="module", params=C.MESHES)
def recs(request, tmp_path_factory):
    mesh = request.param
    return mesh, C.records(tmp_path_factory.mktemp(f"dry_prefill_{mesh}"),
                           mesh, "prefill")


@pytest.mark.parametrize("cell", list(C.PREFILL_CELLS))
def test_lm_prefill_cell_on_each_mesh(recs, cell):
    mesh, out = recs
    C.check(out, cell, mesh)
