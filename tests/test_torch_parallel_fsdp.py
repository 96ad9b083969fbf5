"""The port's FSDP (ZeRO-3) training on 2 gloo ranks of the CPU against the
JAX package's FSDP on a 2-device slice of the 8-device CPU mesh
(tests/parallel/test_fsdp.py's cases): the sharding rule, the state each
rank holds, SGD, Adam with EMA, every memory lever at once and the
checkpoint round trip; and the trunk kernel's route under FSDP. All ranks
run once, in the module's fixture (tests/_ranks_fsdp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from _ranks import assert_close, flat, start_ranks
from simplesr_tpu.parallel import leaf_spec as jax_leaf_spec
from simplesr_tpu.parallel import make_mesh as jax_make_mesh
from simplesr_tpu.parallel import state_shardings as jax_state_shardings
from simplesr_tpu.train import Generator as JaxGenerator
from simplesr_tpu.train import SRModel as JaxSRModel
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu_torch.parallel import leaf_spec, state_shardings
from simplesr_tpu_torch.parallel.fsdp import _flax_dims
from simplesr_tpu_torch.train import Generator, SRModel
from simplesr_tpu_torch.train.convert import _flax_path
from simplesr_tpu_torch.train.serialization import save_model

WORLD = 2
SGD = dict(rtol=1e-4, atol=1e-5)   # tests/parallel/test_fsdp.py:118
ADAM = dict(rtol=5e-3, atol=5e-4)  # tests/parallel/test_fsdp.py:140


def _cfg(root):
    from _ranks_dp import cfg
    return cfg(root)


@pytest.fixture(scope="module", autouse=True)
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp")
    rng = np.random.default_rng(0)
    inputs = {
        "batch": (rng.uniform(0, 1, (8, 8, 8, 3)).astype(np.float32),
                  rng.uniform(-1, 1, (8, 16, 16, 3)).astype(np.float32)),
        "big_batch": (rng.uniform(0, 1, (16, 8, 8, 3)).astype(np.float32),
                       rng.uniform(-1, 1, (16, 16, 16, 3)).astype(np.float32)),
    }
    for name, nf, dtype in (("gen", 16, "float32"), ("gen64", 64, "bfloat16")):
        gen = Generator.srresnet(2, num_blocks=1, num_filters=nf, batch_norm=False,
                                 dtype=dtype, seed=2, device="cpu")
        inputs[name] = str(root / f"{name}.msgpack")
        save_model(gen.module_config(), gen.variables, inputs[name])
    return inputs, start_ranks("_ranks_fsdp", "body", WORLD, root / "ranks", inputs), root


def _jax_model(inputs, root, mesh, fsdp, optimizer="SGD", lr=0.1, **kw):
    module, variables = jax_load_model(inputs["gen"])
    gen = JaxGenerator.srresnet(upsample_factor=2, num_blocks=1, num_filters=16,
                                batch_norm=False, dtype=jnp.float32, input_dims=(8, 8),
                                pretrained_model=(module, variables))
    return JaxSRModel("resnet", gen, optimizer, {"learning_rate": lr}, config=_cfg(root),
                      mesh=mesh, fsdp=fsdp, seed=0, async_checkpointing=False, **kw)


def _params(model, tree="g_params"):
    return {"params": jax.device_get(getattr(model.state, tree))}


def _mesh():
    return jax_make_mesh(devices=jax.devices()[:WORLD])


def test_leaf_spec_rules_match_jax():
    shapes = [(3, 3, 64, 64), (3, 3, 64, 128), (3, 3, 128, 64), (3, 3, 3, 9), (8,), (64,)]
    for shape in shapes:
        for n in (2, 8):
            assert leaf_spec(shape, n) == tuple(jax_leaf_spec(shape, n))
    assert leaf_spec((64,), 8, min_elems=16) == tuple(jax_leaf_spec((64,), 8, min_elems=16))


@pytest.mark.parametrize("arch", ["srresnet", "rrdb"])
def test_state_shardings_split_the_leaves_jax_splits(arch, tmp_path):
    """The port's specs, carried into flax's layouts, are the JAX package's
    on the same model, the pixel-shuffle tail replicated in both."""
    kw = dict(num_blocks=1, num_filters=16, dtype="float32", device="cpu")
    gen = Generator.srresnet(4, batch_norm=True, **kw) if arch == "srresnet" \
        else Generator.rrdb(4, num_dense_blocks=1, num_convs=2, **kw)
    path = str(tmp_path / "m.msgpack")
    save_model(gen.module_config(), gen.variables, path)
    _, variables = jax_load_model(path)
    jax_specs = jax_state_shardings(jax_make_mesh(), variables["params"])
    leaves = jax.tree_util.tree_flatten_with_path(
        jax_specs, is_leaf=lambda s: isinstance(s, NamedSharding))[0]
    jax_by_path = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
                   for path, s in leaves}
    port = state_shardings(8, gen.model().named_parameters())
    split = 0
    for name, p in gen.model().named_parameters():
        _, fpath = _flax_path(name, p.dim())
        spec = port[name]
        dims = _flax_dims(p.dim())
        flax_spec = ()
        if spec:
            flax_dim = dims.index(len(spec) - 1)
            flax_spec = (None,) * flax_dim + ("data",)
        assert flax_spec == jax_by_path["/".join(fpath)], name
        split += bool(spec)
    assert split > 0 and len(port) == len(jax_by_path)


def test_fsdp_training_matches_jax_fsdp(setup, tmp_path):
    inputs, ranks, _ = setup
    jm = _jax_model(inputs, tmp_path, _mesh(), True)
    lr, hr = inputs["batch"]
    for _ in range(3):
        jm.train_step(lr, hr)
        jm.validation_step(lr, hr)
    for out in ranks:
        assert_close(out["sgd"], _params(jm), **SGD)


def test_state_is_held_at_one_nth_per_rank(setup):
    _, ranks, _ = setup
    for out in ranks:
        assert out["shard_count"] > 0
        saw_tail = saw_split = False
        for name, (module_now, shard) in out["held"].items():
            full = out["full_sizes"][name]
            if out["specs"][name]:
                assert (module_now, shard * WORLD) == (0, full), name
                saw_split = True
            else:
                assert module_now == shard == full, name
                saw_tail |= name.startswith("upsample.") and full >= 2 ** 11
        assert saw_split and saw_tail
        # Adam's moments, the EMA shadow and the gradient accumulator ride
        # the same shards
        sizes = [s for _, s in out["held"].values()]
        assert out["moments"] == {"mu": sizes, "nu": sizes}
        assert out["ema_sizes"] == sizes
        assert out["acc_sizes"] == sizes
    assert ranks[0]["acc_file_sizes"] == list(ranks[0]["full_sizes"].values())


def test_fsdp_requires_mesh():
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, device="cpu", dtype="float32")
    with pytest.raises(ValueError, match="mesh"):
        SRModel("resnet", gen, fsdp=True, device="cpu")


def test_fsdp_composes_with_ema_and_adam(setup, tmp_path):
    inputs, ranks, _ = setup
    jm = _jax_model(inputs, tmp_path, _mesh(), True, optimizer="Adam", lr=1e-3, ema_decay=0.9)
    lr, hr = inputs["batch"]
    for _ in range(2):
        jm.train_step(lr, hr)
    for out in ranks:
        assert_close(out["adam"], _params(jm), **ADAM)
        assert_close(out["ema"], _params(jm, "g_ema_params"), **ADAM)


def test_all_memory_levers_compose(setup, tmp_path):
    """fsdp + remat + two accumulated half batches, a checkpoint saved and
    restored between them, == one plain step on the whole batch (the JAX
    package's plain single-device run)."""
    inputs, ranks, _ = setup
    jm = _jax_model(inputs, tmp_path, None, False)
    jm.train_step(*inputs["big_batch"])
    for out in ranks:
        assert_close(out["levers"], _params(jm), **SGD)


def test_checkpoint_roundtrip_replaces_shardings(setup):
    _, ranks, _ = setup
    for out in ranks:
        ck = out["ck"]
        assert_close(ck["restored"], ck["saved"], rtol=0, atol=0)
        for name, (module_now, shard) in ck["held"].items():
            assert module_now == (0 if out["specs"][name] else shard), name
        assert any(np.abs(a - b).max() > 0 for a, b in
                   zip(flat(ck["after"]).values(), flat(ck["saved"]).values()))
    # rank 0 wrote the whole state: parameters and Adam's moments
    state = ranks[0]["ck"]["file"]
    for name, t in state["params"].items():
        assert t.numel() == ranks[0]["full_sizes"][name]
    mu = state["optimizer"]["inner"]["slots"]["mu"]
    assert [t.numel() for t in mu] == list(ranks[0]["full_sizes"].values())


def test_a_nonfinite_gradient_in_one_shard_is_skipped_on_every_rank(setup):
    """Without accumulation too, the NaN guard's verdict is the ranks'
    together: a NaN in the last rank's shard drops the step everywhere, and
    the next step applies everywhere, the ranks' state equal."""
    _, ranks, _ = setup
    for out in ranks:
        nan = out["nan"]
        assert (nan["notfinite"], nan["count"]) == (1, 0)
        assert_close(nan["skipped"], nan["before"], rtol=0, atol=0)
        assert any(np.abs(a - b).max() > 0 for a, b in
                   zip(flat(nan["after"]).values(), flat(nan["before"]).values()))
        assert_close(nan["after"], ranks[0]["nan"]["after"], rtol=0, atol=0)


def test_the_trunk_kernel_packs_whole_weights_and_keeps_no_copy(setup, tmp_path):
    inputs, ranks, _ = setup
    for out in ranks:
        k = out["kernel"]
        assert k["uses"]
        assert k["seen"] and all(s[0] == (64, 64, 3, 3) and s[3] == (64, 64, 3, 3)
                                 for s in k["seen"])
        assert k["packed_after"] is None
    # and trains as one process does
    gen = Generator.srresnet(2, num_blocks=1, num_filters=64, batch_norm=False,
                             dtype="bfloat16", pretrained_model_path=inputs["gen64"],
                             device="cpu")
    single = SRModel("resnet", gen, "SGD", {"learning_rate": 0.1}, config=_cfg(tmp_path),
                     device="cpu")
    lr, hr = inputs["batch"]
    single.train_step(lr, hr)
    single.train_step(lr, hr)
    from _ranks_dp import variables
    for out in ranks:
        assert_close(out["kernel"]["vars"], variables(single.generator()), rtol=1e-2, atol=1e-3)
