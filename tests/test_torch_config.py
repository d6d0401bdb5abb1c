"""The port's own copies of ``config.py`` and ``ops/anchors.py`` equal the
JAX package's: every dataclass field by field with its default, and the
anchor pyramid exactly (both are plain Python and numpy, so exact)."""

import dataclasses

import numpy as np
import pytest

from retinanet_tpu import config as jcfg
from retinanet_tpu.ops import anchors as janchors
from retinanet_tpu_torch import config as tcfg
from retinanet_tpu_torch.ops import anchors as tanchors

_COPIED = ("AnchorConfig", "AssignConfig", "LossConfig", "ModelConfig",
           "DataConfig", "TrainConfig", "NMSConfig", "ParallelConfig",
           "Config")


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = f.default_factory()
    return out


@pytest.mark.parametrize("name", _COPIED)
def test_config_dataclass_matches_jax(name):
    """Same field names in the same order, same defaults, ``Config``'s
    ``parallel`` (``ParallelConfig``) included."""
    want = _defaults(getattr(jcfg, name))
    got = _defaults(getattr(tcfg, name))
    if name == "Config":
        for key in want:
            assert dataclasses.asdict(got[key]) == dataclasses.asdict(
                want[key]), key
        assert list(got) == list(want)
        replaced = tcfg.Config().replace(
            model=tcfg.ModelConfig(fused_train=True))
        assert replaced.model.fused_train and replaced.data == tcfg.DataConfig()
        return
    assert list(got) == list(want)
    assert got == want
    assert dataclasses.is_dataclass(getattr(tcfg, name))
    assert getattr(tcfg, name).__dataclass_params__.frozen


def test_anchor_config_properties_match_jax():
    assert tcfg.AnchorConfig().num_anchors == jcfg.AnchorConfig().num_anchors
    assert tcfg.AnchorConfig().levels == jcfg.AnchorConfig().levels


@pytest.mark.parametrize("size", [64, 640, (640, 448)])
def test_anchor_pyramid_matches_jax(size):
    want = janchors.build_levels()
    got = tanchors.build_levels()
    assert list(got) == list(want) and got.num_anchors == want.num_anchors
    for pn in want:
        assert got.grid_hw(pn, size) == want.grid_hw(pn, size)
        assert got.stride(pn) == want.stride(pn)
        np.testing.assert_array_equal(got[pn].anchor_sizes,
                                      want[pn].anchor_sizes)
        np.testing.assert_array_equal(got.normalized_anchor_sizes(pn, size),
                                      want.normalized_anchor_sizes(pn, size))
    a = tanchors.flat_anchor_maps(got, size)
    b = janchors.flat_anchor_maps(want, size)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert tanchors.image_hw(size) == janchors.image_hw(size)


@pytest.mark.parametrize("dotted,value", [
    ("data.image_size", 320), ("model.fused_blocks", True),
    ("nms.score_threshold", 0.005), ("data.buckets", ((640, 448),)),
    ("data.dataset", ("shapes", "/tmp/s", "64", "640"))])
def test_apply_dotted_matches_jax(dotted, value):
    """The CLIs' config helper replaces the same field in both packages and
    leaves every other section as it was."""
    got = tcfg._apply_dotted(tcfg.Config(), dotted, value)
    want = jcfg._apply_dotted(jcfg.Config(), dotted, value)
    for f in dataclasses.fields(tcfg.Config):
        assert dataclasses.asdict(getattr(got, f.name)) == \
            dataclasses.asdict(getattr(want, f.name)), f.name
    with pytest.raises(TypeError):
        tcfg._apply_dotted(tcfg.Config(), "data.no_such_field", 1)


@pytest.mark.parametrize("specs", [["640x640"],
                                   ["640x448", "448X640", "64x48"]])
def test_parse_buckets_matches_jax(specs):
    assert tcfg.parse_buckets(specs) == jcfg.parse_buckets(specs)
