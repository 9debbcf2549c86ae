"""Faults planted under the timed path, for the tests and the calibration
(never in a benchmark run).  Each of ``FAULTS`` takes the Booster right
after it is built and breaks what ``Booster.update()`` does; each of
``DEPARTURES`` is parameters given to the program alone (the reference
keeps the ones the configuration states)."""
from __future__ import annotations


def unchanged(bst) -> None:
    """A step that returns its state unchanged: no tree, no score."""
    bst._gbdt.train_one_iter = lambda *a, **k: False


def stale_scores(bst) -> None:
    """A step that returns the training scores, the state one iteration
    hands the next, unchanged, while its tree still enters the model."""
    gb = bst._gbdt
    add = gb._add_tree

    def wrapped(*args):
        before = gb._train_score
        add(*args)
        gb._train_score = before
    gb._add_tree = wrapped


def half_rows(bst) -> None:
    """Half of the rows left out of every tree: the sample mask drops the
    second half, and the sums are taken over the rest."""
    gb = bst._gbdt
    sample = gb._sample

    def wrapped(it, g, h):
        out = sample(it, g, h)
        mask = gb._bag_mask.clone()
        mask[mask.shape[0] // 2:] = 0
        gb._bag_mask = mask
        return out
    gb._sample = wrapped


def altered_leaf(bst) -> None:
    """An answer altered where it is produced: each grown tree's first leaf
    value moved by the tree's median leaf value before it enters the model
    and the scores."""
    gb = bst._gbdt
    add = gb._add_tree

    def wrapped(k, arrs, leaf_id, stats, init_score):
        lv = arrs.leaf_value.clone()
        lv[0] = lv[0] + lv[:int(arrs.num_leaves)].abs().median()
        return add(k, arrs._replace(leaf_value=lv), leaf_id, stats,
                   init_score)
    gb._add_tree = wrapped


FAULTS = {"unchanged": unchanged, "stale_scores": stale_scores,
          "half_rows": half_rows, "altered_leaf": altered_leaf}

DEPARTURES = {
    # a quarter of the bins the configuration asks for
    "coarse_bins": {"max_bin": 63},
    # the split scan tries half of the features of each tree
    "partial_scan": {"feature_fraction": 0.5},
}
