"""The port's logical-axis rules (``repro_torch.dist``) against the
reference's (``repro.dist``): counterparts of tests/test_dist_units.py's
``resolve_axes`` cases and tests/test_dist.py::TestRules, each run
through both packages on the same axes, shapes and mesh sizes, the
port's placement tuples compared with the reference's ``PartitionSpec``
taken as a tuple; then ``data_mesh_axes``, ``dp_partition_spec``,
``data_shard_count``, the ambient-mesh context, and ``constrain``
(identity off a mesh and on the data axis; on a width axis of a
``model > 1`` mesh, this rank's block, a view).
"""
import types

import pytest
import torch

from repro.dist import compression as J_C
from repro.dist import rules as J_R
from repro_torch import dist as T_dist
from repro_torch.dist import compression as T_C
from repro_torch.dist import rules as T_R
from repro_torch.launch.mesh import HostMesh, make_host_mesh


def _mesh(**shape):
    """Duck-typed stand-in: the resolver reads ``mesh.shape`` only."""
    return types.SimpleNamespace(shape=dict(shape))


# (logical axes, shape, mesh shape, rules, the reference test's claim)
CASES = {
    "batch_over_joint_pod_data": (("batch", "seq"), (8, 16),
                                  dict(pod=2, data=2, model=2), None),
    "batch_filters_to_present_axes": (("batch",), (8,),
                                      dict(data=4, model=2), None),
    "width_axes_take_model": (("embed", "mlp"), (32, 64),
                              dict(data=4, model=2), None),
    "divisibility_falls_back_to_replicated": (("vocab",), (7,),
                                              dict(model=4), None),
    "joint_axes_drop_trailing_until_divisible": (("batch",), (6,),
                                                 dict(pod=2, data=2), None),
    "first_dim_wins_conflict": (("mlp", "mlp"), (8, 8), dict(model=2),
                                None),
    "none_and_unknown_names_replicate": ((None, "code_split"), (4, 4),
                                         dict(model=2), None),
    "rules_override": (("embed",), (8,), dict(model=2),
                       {"embed": ("model",)}),
    # tests/test_dist.py::TestRules on (2, 4) and (2, 2, 2) meshes
    "heads_divisible_shards": (("embed", "heads", "head_dim"), (64, 40, 16),
                               dict(data=2, model=4), None),
    "heads_indivisible_replicates": (("embed", "heads", "head_dim"),
                                     (64, 6, 16), dict(data=2, model=4),
                                     None),
    "axis_conflict_first_dim": (("mlp", "mlp"), (8, 8),
                                dict(data=2, model=4), None),
    "batch_prefers_pod_data": (("batch", "seq"), (8, 16),
                               dict(pod=2, data=2, model=2), None),
    "pairs_rules": (("items", "embed"), (12, 8), dict(data=3, model=4),
                    (("items", ("data",)), ("embed", ("model",)))),
}

CLAIMS = {
    "batch_over_joint_pod_data": (("pod", "data"), None),
    "batch_filters_to_present_axes": ("data",),
    "width_axes_take_model": (None, "model"),
    "divisibility_falls_back_to_replicated": (None,),
    "joint_axes_drop_trailing_until_divisible": ("pod",),
    "first_dim_wins_conflict": ("model", None),
    "none_and_unknown_names_replicate": (None, None),
    "rules_override": ("model",),
    "heads_divisible_shards": (None, "model", None),
    "heads_indivisible_replicates": (None, None, None),
    "axis_conflict_first_dim": ("model", None),
    "batch_prefers_pod_data": (("pod", "data"), None),
    "pairs_rules": ("data", "model"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_resolve_axes_equals_the_reference(name):
    axes, shape, mesh_shape, rules = CASES[name]
    want = tuple(J_R.resolve_axes(axes, shape, _mesh(**mesh_shape), rules))
    got = T_R.resolve_axes(axes, shape, _mesh(**mesh_shape), rules)
    assert got == want == CLAIMS[name]


def test_resolve_axes_length_mismatch_raises():
    with pytest.raises(ValueError, match="logical axes"):
        T_R.resolve_axes(("batch",), (8, 8), _mesh(data=2))


def test_default_rules_and_data_axes_equal_the_reference():
    assert T_R.DEFAULT_RULES == J_R.DEFAULT_RULES
    assert T_R.DATA_AXES == J_R.DATA_AXES
    for name in ("batch", "mlp", "heads", "vocab", "items", "table",
                 "centroid", "expert"):
        assert name in dict(T_R.DEFAULT_RULES)


@pytest.mark.parametrize("shape", [dict(data=4, model=2),
                                   dict(pod=2, data=2, model=2),
                                   dict(model=8), dict(data=1, model=1)])
def test_data_axes_and_partition_spec_equal_the_reference(shape):
    m = _mesh(**shape)
    assert T_R.data_mesh_axes(m) == J_R.data_mesh_axes(m)
    assert T_C.dp_shard_count(m) == J_C.dp_shard_count(m)
    assert T_C.dp_partition_spec(m) == tuple(J_C.dp_partition_spec(m))


def test_context_manager_installs_and_restores():
    assert T_R._CTX.mesh is None
    m = _mesh(data=2)
    with T_R.use_mesh_rules(m, rules={"x": ("data",)}):
        assert T_R._CTX.mesh is m
        assert T_R._CTX.rules == {"x": ("data",)}
        assert T_dist.data_shard_count() == 2
    assert T_R._CTX.mesh is None and T_R._CTX.rules is None
    assert T_dist.data_shard_count() == 1


def test_constrain_identity_and_next_slice():
    x = torch.arange(8.0).reshape(4, 2)
    assert T_dist.constrain(x, ("batch", "mlp")) is x           # off-mesh
    with T_R.use_mesh_rules(HostMesh(2)):
        assert T_dist.constrain(x, ("batch", "mlp")) is x    # model == 1
    with T_R.use_mesh_rules(_mesh(data=2, model=2)):
        assert T_dist.constrain(x, ("batch", None)) is x     # data axis
    # a width axis on model > 1 (item 9c): this rank's block, a view
    for m in range(2):
        with T_R.use_mesh_rules(HostMesh(2, 2, rank=2 + m)):
            got = T_dist.constrain(x, ("batch", "mlp"))
            assert torch.equal(got, x[:, m:m + 1])
            assert got.untyped_storage().data_ptr() == \
                x.untyped_storage().data_ptr()
    # the model axis itself is ported (serving's mesh branches)
    m = make_host_mesh(4, model=2, group=False)
    assert m.shape == {"data": 2, "model": 2} and m.group is None
    with pytest.raises(ValueError, match="must divide"):
        make_host_mesh(4, model=3, group=False)


def test_host_mesh_shape_matches_the_reference_axes():
    m = HostMesh(4)
    assert tuple(m.shape) == ("data", "model") == m.axis_names
    assert m.shape == {"data": 4, "model": 1} and m.world_size == 4
    with pytest.raises(ValueError, match="process"):
        make_host_mesh(2)
