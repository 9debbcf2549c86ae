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
    """Every refusal names a bold item of ROADMAP.md's port queue."""
    import os
    roadmap = open(os.path.join(os.path.dirname(__file__), os.pardir,
                                "ROADMAP.md")).read()
    items = {pconfig.refused_item(f.name) for f in FIELDS} - {None}
    assert items
    for item in items:
        assert item.split(": ")[-1] in roadmap, item


SERVE_FIELDS = [f for f in FIELDS
                if f.name.startswith(("tpu_serve", "tpu_explain"))]
# the serving fields the port still refuses, by the item that brings them
SERVE_REFUSED = {"tpu_serve_aot_dir": "serve AOT store",
                 "tpu_serve_rollback_on_drift": "Obs, tools and bindings"}


@pytest.mark.parametrize("fld", SERVE_FIELDS, ids=lambda f: f.name)
def test_serve_field_runs_or_names_its_item(fld):
    """Every ``tpu_serve_*``/``tpu_explain*`` field takes a non-default
    value (``serve/`` reads it), except the AOT store's directory and the
    drift rollback, refused by their items.  Floats are halved (0 becomes
    0.5), so fractions stay in range."""
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
