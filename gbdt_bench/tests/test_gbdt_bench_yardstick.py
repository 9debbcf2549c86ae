"""The needed-work count on a hand-written two-tree model text."""
import pytest

from gbdt_bench import yardstick
from gbdt_bench.reference import model_text

MODEL = """tree
version=v3
num_class=1

Tree=0
num_leaves=3
num_cat=0
split_feature=0 1
split_gain=10 5
threshold=0.5 -0.25
decision_type=2 2
left_child=-1 -2
right_child=1 -3
leaf_value=0.1 -0.2 0.3
leaf_weight=7 10 7.5
leaf_count=30 40 30
internal_value=0 -0.05
internal_weight=24.5 17.5
internal_count=100 70
shrinkage=0.1


Tree=1
num_leaves=1
num_cat=0
split_feature=
split_gain=
threshold=
decision_type=
left_child=
right_child=
leaf_value=0.5
leaf_weight=
leaf_count=
internal_value=
internal_weight=
internal_count=
shrinkage=1


end of trees
"""


def test_parse_two_trees():
    a, b = model_text.parse_trees(MODEL)
    assert a["num_leaves"] == 3 and b["num_leaves"] == 1
    assert list(a["left_child"]) == [-1, -2]
    assert list(a["leaf_count"]) == [30, 40, 30]
    assert model_text.depth(a) == 2 and model_text.depth(b) == 0
    p_int, p_leaf = model_text.parents(a)
    assert list(p_int) == [-1, 0] and list(p_leaf) == [0, 1, 1]


def test_hist_rows_root_then_smaller_child():
    a, b = model_text.parse_trees(MODEL)
    assert yardstick.hist_rows(a) == 100 + 30 + 30
    assert yardstick.hist_rows(b) == 0


def test_costs_of_the_two_trees():
    a, b = model_text.parse_trees(MODEL)
    ops, nbytes = yardstick.hist_cost(a, 28, 255)
    assert ops == 160 * 28 * 3
    assert nbytes == 160 * (28 + 8) + 3 * 28 * 255 * 3 * 4
    assert yardstick.hist_cost(b, 28, 255) == (0.0, 0.0)
    ops2, nbytes2 = yardstick.iteration_cost(a, 100, 28, 255, pair_slots=50)
    assert ops2 == ops + 50
    assert nbytes2 == nbytes + 100 * 8 * 3
    assert yardstick.iteration_cost(b, 100, 28, 255) == (0.0, 2400.0)
    assert yardstick.least_seconds(ops2, nbytes2) == pytest.approx(
        nbytes2 / 3.35e12)
    assert yardstick.least_seconds(67e12, 1.0) == pytest.approx(1.0)


def test_two_byte_bins_past_256():
    a, _ = model_text.parse_trees(MODEL)
    assert yardstick.hist_cost(a, 28, 1023)[1] == \
        160 * (56 + 8) + 3 * 28 * 1023 * 3 * 4
