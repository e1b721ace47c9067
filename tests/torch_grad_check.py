"""Gradient and optimizer-step comparisons shared by the port's train-path
tests (``test_torch_lm_train.py``, ``test_torch_ctr_gnn.py``): trees in
the reference's layout, as numpy, compared leaf by leaf.

A gradient is held to 1e-5 of its leaf's largest |g|. After an AdamW step
(whose first update is about lr·sign(g)) a parameter is held to 1e-5 of
its leaf's largest value where its gradient is 0 or above SIGN_FLOOR of
the leaf's largest |g|, and within 2·lr elsewhere (a near-zero gradient's
sign may differ between packages).
"""
import jax
import numpy as np
import torch

GRAD_TOL = 1e-5          # relative to a leaf's largest |g|
SIGN_FLOOR = 1e-3        # |g| below this share of the leaf's max: exempt
ZERO_LEAF = 1e-4         # a leaf this far below the tree's max |g| is 0


def _np(x):
    return np.asarray(x, np.float32)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), _np(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_grads(got, want, tol=GRAD_TOL, zero_leaf=ZERO_LEAF):
    """Two gradient trees (reference layout, numpy) leaf by leaf:
    |a - b| <= tol · max|b| of the leaf. A leaf whose largest |b| is below
    ``zero_leaf`` of the tree's largest has an exact gradient of 0 (DIEN's
    attention bias before its softmax, which a shift does not change): its
    values are rounding noise, held to tol · zero_leaf of the tree's
    largest (ZERO_LEAF**2 for AdamW's second moment, a square)."""
    pairs = list(zip(_leaves(got), _leaves(want)))
    top = max([float(np.abs(b).max()) for _, (_, b) in pairs] + [1e-30])
    for (path, a), (path2, b) in pairs:
        assert path == path2
        scale = max(float(np.abs(b).max()), zero_leaf * top, 1e-30)
        err = float(np.abs(a - b).max()) / scale
        assert err <= tol, (path, err)


def assert_step(got, want, grads, lr):
    """Updated params against the reference's, to 1e-5 of the leaf's
    largest value, wherever the gradient is 0 (a pure weight-decay update)
    or above SIGN_FLOOR of its leaf's largest |g| (of ZERO_LEAF of the
    tree's, for a leaf whose exact gradient is 0); the rest (0 < |g| <=
    the floor, where a sign may differ) within 2·lr. Returns the count of
    the rest."""
    rest = 0
    gl = _leaves(grads)
    top = max([float(np.abs(g).max()) for _, g in gl] + [1e-30])
    for (path, a), (_, b), (_, g) in zip(_leaves(got), _leaves(want), gl):
        floor = SIGN_FLOOR * max(float(np.abs(g).max()), ZERO_LEAF * top)
        small = (np.abs(g) <= floor) & (g != 0)
        scale = max(float(np.abs(b).max()), 1e-30)
        diff = np.abs(a - b)
        if (~small).any():
            err = float(diff[~small].max()) / scale
            assert err <= 1e-5, (path, err)
        if small.any():
            assert float(diff[small].max()) <= 2 * lr + 1e-5 * scale, path
        rest += int(small.sum())
    return rest


def _grad_tree(tree):
    """The .grad of every leaf (zeros where the loss does not reach it,
    as jax.grad gives) as numpy."""
    return {k: (_grad_tree(v) if isinstance(v, dict) else
                (v.grad if v.grad is not None else torch.zeros_like(v))
                .numpy()) for k, v in tree.items()}


def _requires_grad(tree):
    for v in tree.values():
        if isinstance(v, dict):
            _requires_grad(v)
        else:
            v.requires_grad_(True)
