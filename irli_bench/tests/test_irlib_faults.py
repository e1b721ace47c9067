"""A run whose timed path is broken underneath comes out not correct: the
rest of a run (set-up, window, check) driven on the CPU at the tiny size,
the card's look skipped, with each fault a cell can have planted in the
port: an answer altered where it is made, half of the batch left out.
One chip a cell, so no exchange between chips to leave out; a search
keeps no state that a step could leave unchanged."""
import dataclasses
import time

import pytest
import torch

import tiny
from irli_bench import run
from repro_torch.core import search_api

SEARCH_CELLS = ["deep1b-batch", "sift1m-batch", "deep1b-served"]


def execute(name: str):
    result, _ = run.execute(tiny.cell(name), 2**31 + 77, 0.3, False,
                            torch.device("cpu"), time.perf_counter())
    return result


def altered(res):
    """The first query's best id replaced by another where it is made."""
    ids = res.ids.clone()
    ids[0, 0] = (ids[0, 0] + 1) % 1000
    return dataclasses.replace(res, ids=ids)


def half_left_out(search):
    """Only the first half of the batch searched (none of a batch of one);
    the rest answered as if nothing had survived."""
    def wrapped(self, params, scorer, members, base, queries, *a, **kw):
        Q, k = queries.shape[0], params.k
        keep = Q // 2
        none = search_api.SearchResult(
            ids=torch.full((Q - keep, k), -1, dtype=torch.int32),
            scores=torch.full((Q - keep, k), -torch.inf),
            n_candidates=torch.zeros(Q - keep, dtype=torch.int32))
        if keep == 0:
            return none
        res = search(self, params, scorer, members, base, queries[:keep],
                     *a, **kw)
        return dataclasses.replace(
            res, ids=torch.cat([res.ids, none.ids]),
            scores=torch.cat([res.scores, none.scores]),
            n_candidates=torch.cat([res.n_candidates.to(torch.int32),
                                    none.n_candidates]))
    return wrapped


@pytest.mark.parametrize("name", SEARCH_CELLS)
def test_the_sound_port_is_correct(name):
    assert execute(name)["correct"]


@pytest.mark.parametrize("name", SEARCH_CELLS)
def test_an_answer_altered_where_made_is_caught(name, monkeypatch):
    search = search_api.PipelineCache.search
    monkeypatch.setattr(search_api.PipelineCache, "search",
                        lambda *a, **kw: altered(search(*a, **kw)))
    result = execute(name)
    assert not result["correct"]
    assert result["check"]["mismatch"]["value"] > 0


@pytest.mark.parametrize("name", SEARCH_CELLS)
def test_half_the_batch_left_out_is_caught(name, monkeypatch):
    monkeypatch.setattr(search_api.PipelineCache, "search",
                        half_left_out(search_api.PipelineCache.search))
    result = execute(name)
    assert not result["correct"]

