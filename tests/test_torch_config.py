"""Every parameter of the JAX package's ``Config`` is a field of the
port's, with its default; the port runs it, accepts it where the JAX
package gives it no effect, or refuses a non-default value with a
``LightGBMError`` naming its ROADMAP.md item.  ``Unknown parameter`` is
left for names neither package knows.

The cases are the port's fields (no JAX import while collecting: the
card's test run has no jax); each checks its JAX counterpart."""
import dataclasses

import pytest

from lightgbm_tpu_torch import config as pconfig
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.utils import log
from lightgbm_tpu_torch.utils.log import LightGBMError

FIELDS = [f for f in dataclasses.fields(Config)]


def _default(f):
    return (f.default if f.default is not dataclasses.MISSING
            else f.default_factory())


def _other_value(v):
    if isinstance(v, bool):
        return not v
    if isinstance(v, int):
        return v + 7
    if isinstance(v, float):
        return v + 0.5
    if isinstance(v, str):
        return v + "x"
    return [1]


@pytest.fixture(scope="module")
def jax_fields():
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as JConfig
    return {f.name: f for f in dataclasses.fields(JConfig)}


def test_same_field_set(jax_fields):
    assert set(jax_fields) == {f.name for f in FIELDS}


@pytest.fixture()
def warnings_seen(monkeypatch):
    seen = []
    monkeypatch.setattr(log, "warning",
                        lambda msg, *a: seen.append(msg % a if a else msg))
    return seen


@pytest.mark.parametrize("fld", FIELDS, ids=lambda f: f.name)
def test_field_is_implemented_accepted_or_refused(fld, jax_fields,
                                                  warnings_seen):
    d = _default(fld)
    if fld.name != "device_type":      # tpu there, cuda here
        assert d == _default(jax_fields[fld.name])
    Config.from_params({fld.name: d})
    assert not [w for w in warnings_seen if "Unknown parameter" in w]
    item = pconfig.refused_item(fld.name)
    if item is not None:
        with pytest.raises(LightGBMError, match="ROADMAP.md port queue: "
                           + item):
            Config.from_params({fld.name: _other_value(d)})


def test_unknown_names_still_warn(warnings_seen):
    Config.from_params({"no_such_parameter": 1})
    assert any("Unknown parameter: no_such_parameter" in w
               for w in warnings_seen)


def test_refused_items_are_roadmap_items():
    """Every refusal names a bold item of ROADMAP.md's port queue: since
    item 8B no field waits for an item, and the one refusal left, the CPU
    fallback of a failed device step (for good), names its own."""
    import os
    roadmap = open(os.path.join(os.path.dirname(__file__), os.pardir,
                                "ROADMAP.md")).read()
    items = {pconfig.refused_item(f.name) for f in FIELDS} - {None}
    assert items == set()
    items.add(pconfig._FALLBACK)
    for item in items:
        assert item.split(": ")[-1] in roadmap, item
    with pytest.raises(LightGBMError, match="ROADMAP.md port queue: "
                       + pconfig._FALLBACK):
        Config.from_params({"tpu_on_device_error": "fallback"})


SERVE_FIELDS = [f for f in FIELDS
                if f.name.startswith(("tpu_serve", "tpu_explain"))]
# the serving fields the port still refuses, by the item that brings them
# (none since serve/aot.py was ported)
SERVE_REFUSED = {}


@pytest.mark.parametrize("fld", SERVE_FIELDS, ids=lambda f: f.name)
def test_serve_field_runs_or_names_its_item(fld):
    """Every ``tpu_serve_*``/``tpu_explain*`` field takes a non-default
    value (``serve/`` reads it, the store's directory included).  Floats
    are halved (0 becomes 0.5), so fractions stay in range."""
    d = _default(fld)
    value = ((d / 2 if d else 0.5) if isinstance(d, float)
             else _other_value(d))
    if fld.name in SERVE_REFUSED:
        assert pconfig.refused_item(fld.name) == SERVE_REFUSED[fld.name]
        with pytest.raises(LightGBMError, match="ROADMAP.md port queue: "
                           + SERVE_REFUSED[fld.name]):
            Config.from_params({fld.name: value})
    else:
        assert pconfig.refused_item(fld.name) is None
        assert getattr(Config.from_params({fld.name: value}),
                       fld.name) == value


# the observability fields the port runs since its obs/ plane, with a
# non-default value each, and item 8B's (the train board, the profiler
# window), which it runs since the board and the window were ported
OBS_RUN = {"tpu_telemetry": "telemetry.jsonl", "tpu_health": "monitor",
           "tpu_profile": True, "tpu_trace": True, "tpu_flight_len": 64,
           "tpu_drift": False, "tpu_drift_sample_rate": 0.5,
           "tpu_drift_check_s": 5.0, "tpu_drift_min_rows": 50,
           "tpu_drift_psi_warn": 0.1, "tpu_quality_window": 100,
           "tpu_quality_drop_warn": 0.1,
           "tpu_serve_rollback_on_drift": True,
           "tpu_quality_profile": False}
OBS_REFUSED = {"tpu_xprof": True, "tpu_xprof_iters": 5,
               "tpu_train_metrics_port": 8080}


@pytest.mark.parametrize("name", sorted(OBS_RUN))
def test_obs_field_runs(name):
    assert pconfig.refused_item(name) is None
    value = OBS_RUN[name]
    assert getattr(Config.from_params({name: value}), name) == value


@pytest.mark.parametrize("name", sorted(OBS_REFUSED))
def test_obs_field_of_item_8b_is_refused(name):
    """Item 8B's fields were refused until the board and the window were
    ported; each now takes its value and names no item."""
    assert pconfig.refused_item(name) is None
    value = OBS_REFUSED[name]
    assert getattr(Config.from_params({name: value}), name) == value


# the network fields and the parallel learners run since parallel/ was
# ported
NETWORK_RUN = {"num_machines": 2, "local_listen_port": 13000, "time_out": 5,
               "machine_list_filename": "mlist.txt",
               "machines": "10.0.0.1:1,10.0.0.2:1", "tpu_mesh_shape": "data:2"}


@pytest.mark.parametrize("name", sorted(NETWORK_RUN))
def test_network_field_runs(name):
    assert pconfig.refused_item(name) is None
    value = NETWORK_RUN[name]
    assert getattr(Config.from_params({name: value}), name) == value


@pytest.mark.parametrize("alias,want", [
    ("serial", "serial"), ("serial_tree_learner", "serial"),
    ("feature", "feature"), ("feature_parallel", "feature"),
    ("feature_parallel_tree_learner", "feature"), ("data", "data"),
    ("data_parallel", "data"), ("data_parallel_tree_learner", "data"),
    ("voting", "voting"), ("voting_parallel", "voting"),
    ("voting_parallel_tree_learner", "voting"),
    ("voting_tree_learner", "voting")])
def test_tree_learner_aliases_match_the_jax_package(alias, want):
    cfg = Config.from_params({"tree_learner": alias})
    assert cfg.tree_learner == want
    assert cfg.is_parallel == (want != "serial")
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as JConfig
    assert JConfig.from_params({"tree_learner": alias}).tree_learner == want


def test_tree_learner_errors_match_the_jax_package():
    with pytest.raises(LightGBMError, match="Unknown tree learner"):
        Config.from_params({"tree_learner": "gpu"})
    with pytest.raises(LightGBMError, match="monotone constraints"):
        Config.from_params({"tree_learner": "data",
                            "monotone_constraints": [1, 0]})
    with pytest.raises(LightGBMError, match="monotone constraints"):
        Config.from_params({"num_machines": 2,
                            "monotone_constraints": [1]})


# the fleet and ingest families of item 7 run since fleet/ and ingest/
# were ported: a value besides the default of each
FLEET_INGEST_RUN = {
    "tpu_fleet": 2, "tpu_fleet_heartbeat_s": 5.0,
    "tpu_fleet_transport": "host", "tpu_fleet_dir": "fleet",
    "tpu_fleet_port": 13100, "tpu_fleet_min_ranks": 2,
    "tpu_fleet_heal": False, "tpu_fleet_max_recoveries": 3,
    "tpu_ingest": True, "tpu_ingest_chunk_rows": 1000,
    "tpu_ingest_memmap": "bins.npy", "tpu_ingest_shards": 2,
    "tpu_ingest_shard_id": 1, "tpu_ingest_sample_seed": 7}


@pytest.mark.parametrize("name", sorted(
    f.name for f in FIELDS if f.name.startswith(("tpu_fleet", "tpu_ingest"))))
def test_fleet_and_ingest_fields_name_item_7(name):
    """Item 7's families are no longer refused: each field takes a value
    besides its default (the JAX package's checks guard the rest)."""
    assert pconfig.refused_item(name) is None
    value = FLEET_INGEST_RUN[name]
    assert getattr(Config.from_params({name: value}), name) == value
