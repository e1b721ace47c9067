"""The port's dry run of the LM decode_32k and long_500k registry cells
on the multi production mesh (rank 0 of torch's fake process group of
512 ranks, pod 2 x data 16 x model 16), each record held to
the reference's argument bytes where it records the cell, else to rank
0's shards summed independently, and to its launches, host reads, memory
and replication (``tests/torch_dryrun_lm_serve.py``)."""
import pytest

pytest.importorskip("torch")

import torch_dryrun_lm_serve as C  # noqa: E402


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    return C.records(tmp_path_factory.mktemp("dry_lm_multi"), "multi", "decode")


@pytest.mark.parametrize("cell", list(C.DECODE_CELLS))
def test_lm_decode_cell_on_the_multi_mesh(recs, cell):
    C.check(recs, cell, "multi")
