"""The port's dry run of the 20 CTR and SchNet registry cells on the
multi production mesh (rank 0 of torch's fake process group of
512 ranks, pod 2 x data 16 x model 16), each record held to
the reference's (``tests/torch_dryrun_ctr.py``: argument bytes, launches,
the card's memory, replication by the specs)."""
import pytest

pytest.importorskip("torch")

import torch_dryrun_ctr as C  # noqa: E402


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    return C.records(tmp_path_factory.mktemp("dry_ctr_multi"), "multi")


@pytest.mark.parametrize("cell", list(C.REF_ARGS))
def test_ctr_and_schnet_cell_on_the_multi_mesh(recs, cell):
    C.check(recs[cell], cell, "multi")
