"""The port's config registry against the reference's: every architecture's
published and reduced config, the input-shape cells and their skip rules,
equal field for field."""
import dataclasses

import pytest

from repro import configs as ref_configs
from repro_torch import configs as port_configs


def test_registry_lists_the_same_architectures():
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert port_configs._MODULES == ref_configs._MODULES


@pytest.mark.parametrize("name", ref_configs.ARCH_IDS)
def test_published_config_equal_field_for_field(name):
    ref = ref_configs.get_config(name)
    port = port_configs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.attn_dim == ref.attn_dim


@pytest.mark.parametrize("name", ref_configs.ARCH_IDS)
def test_reduced_config_equal_field_for_field(name):
    ref = ref_configs.get_reduced(name)
    port = port_configs.get_reduced(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.replace(n_layers=1)) == \
        dataclasses.asdict(ref.replace(n_layers=1))


def test_shapes_and_skip_rules_equal():
    assert [dataclasses.asdict(s) for s in port_configs.SHAPES] == \
        [dataclasses.asdict(s) for s in ref_configs.SHAPES]
    assert sorted(port_configs.SHAPES_BY_NAME) == \
        sorted(ref_configs.SHAPES_BY_NAME)
    for name in ref_configs.ARCH_IDS:
        for ref_shape, port_shape in zip(ref_configs.SHAPES,
                                         port_configs.SHAPES):
            assert port_configs.shape_skips(
                port_configs.get_config(name), port_shape) == \
                ref_configs.shape_skips(ref_configs.get_config(name),
                                        ref_shape)


def test_moe_configs_the_slice_runs():
    dbrx = port_configs.get_config("dbrx-132b")
    assert (dbrx.d_model, dbrx.d_ff, dbrx.n_experts, dbrx.top_k,
            dbrx.n_shared_experts) == (6144, 10752, 16, 4, 0)
    with pytest.raises(KeyError):
        port_configs.get_config("no-such-arch")
