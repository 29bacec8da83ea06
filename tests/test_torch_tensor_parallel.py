"""Tensor parallel: the port's sliced networks and ``(D, M)`` grids of gloo
ranks against JAX's ``model_parallel`` and against one process.

* ``param_partition_spec`` slices the leaves JAX's slices, on the
  output-channel axis (torch's first, flax's last): every layer at M = 2,
  the convs but not the dense layer at M = 3 (features 24, hidden 32).
* Two gloo ranks (M = 2) hold the slices of one network: its Q-values, the
  loss and the parameters after one Adam step, gathered, against JAX's
  ``train_step`` on a ``(1, 2)`` mesh of the virtual CPU devices with the
  parameters sliced by JAX's ``param_partition_spec``
  (``tests/test_sharding.py``), with ``fused_conv`` on and off, for the
  all-sliced network and a mixed one (hidden 33: the convs sliced, the
  dense layer whole). A gradient summed M times or a permuted channel order
  fails here. A JAX train state carried into the ranks and gathered back is
  the same tree bit for bit.
* ``run_chunks(4, 2)`` on a ``(2, 2)`` grid equals one process with two
  shards (``tests/test_multihost.py``), and ``dryrun_multichip(4)`` runs a
  ``(2, 2)`` mesh.
* ``train()`` on a ``(2, 2)`` grid with frequent sync, prune and
  checkpoints takes one process's path row for row; its checkpoint resumes
  at ``(2, 1)`` and in one process, on the straight run's path.

Float32, dropout 0, features 16, hidden 32, one block unless stated;
JAX's tolerances: parameters ``rtol=2e-4, atol=2e-5``, loss sums
``rtol=1e-3`` (``tests/test_sharding.py:126-136``), integers equal.
"""

import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from test_torch_dqn_agent import batch_of, to_torch_batch
from test_torch_parallel import (LOOP, LOSS_RTOL, PARAM_ATOL, PARAM_RTOL,
                                 assert_digests_agree, assert_rows_agree,
                                 spawn)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048.agents import dqn as jdqn
from tpu2048.parallel import MeshConfig as JaxMeshConfig
from tpu2048.parallel import create_mesh as jax_create_mesh
from tpu2048.parallel import param_partition_spec as jax_partition_spec
from tpu2048_torch.agents import dqn as tdqn
from tpu2048_torch.checkpoint.ckpt import (CheckpointManager,
                                            restore_params_only)
from tpu2048_torch.models import dqn as tmodels
from tpu2048_torch.parallel import mesh, testkit
from tpu2048_torch.training import dqn as ttrain

B = 32
NARROW = dict(features=16, num_blocks=1, bf16=False, dropout=0.0)
# hidden 33 is odd: at M = 2 the dense layer stays whole, the convs slice.
CASES = {
    "four_convs": dict(NARROW, hidden=32, fused_conv=False),
    "fused": dict(NARROW, hidden=32, fused_conv=True),
    "four_convs_mixed": dict(NARROW, hidden=33, fused_conv=False),
    "fused_mixed": dict(NARROW, hidden=33, fused_conv=True),
}


def torch_name(path):
    """The port's state-dict name of a flax parameter's path."""
    if path[0].startswith("block"):
        k = int(path[1][4])  # conv{k}x{k}_kernel|bias
        kind = "weight" if path[1].endswith("kernel") else "bias"
        return f"blocks.{path[0][5:]}.convs.{k - 1}.{kind}"
    return f"{path[0]}.{'weight' if path[1] == 'kernel' else 'bias'}"


def flat_tree(tree, is_leaf=None):
    return {torch_name([str(getattr(k, "key", k)) for k in path]): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


@pytest.mark.parametrize("features,hidden,mp,convs,dense", [
    (16, 32, 2, True, True), (24, 32, 3, True, False)])
def test_param_partition_spec_matches_jax(features, hidden, mp, convs,
                                          dense):
    cfg = dict(features=features, hidden=hidden, num_blocks=2, bf16=False,
               dropout=0.0)
    # The tree's shapes are all the rule reads.
    params = jax.eval_shape(lambda: jdqn.create_train_state(
        jdqn.DQNConfig(**cfg), jax.random.PRNGKey(0))[1].params)
    leaves = flat_tree(params)
    want = flat_tree(jax_partition_spec(params, mp),
                     is_leaf=lambda x: isinstance(x, P))
    got = mesh.param_partition_spec(
        tmodels.create_model(tdqn.DQNConfig(**cfg), "meta"), mp)
    assert set(got) == set(want)
    for name, axis in got.items():
        ndim = leaves[name].ndim
        assert want[name] == (P() if axis is None
                              else P(*[None] * (ndim - 1), "model")), name
    sliced = {n for n, axis in got.items() if axis is not None}
    assert ("blocks.1.convs.3.weight" in sliced) == convs
    assert ("dense.weight" in sliced) == dense
    assert not {"head.weight", "head.bias"} & sliced


def jax_update(kw, seed):
    """JAX's learner update at ``model_parallel=2``: the parameters sliced
    by its partition spec over a ``(1, 2)`` mesh of CPU devices. Returns the
    inputs and the results as numpy trees."""
    jcfg = jdqn.DQNConfig(**kw)
    model, js = jdqn.create_train_state(jcfg, jax.random.PRNGKey(seed))
    grid = jax_create_mesh(JaxMeshConfig(data_parallel=1, model_parallel=2),
                           devices=jax.devices()[:2])
    shardings = jax.tree.map(lambda s: NamedSharding(grid, s),
                             jax_partition_spec(js.params, 2),
                             is_leaf=lambda x: isinstance(x, P))
    params = jax.device_put(js.params, shardings)
    tx = jdqn.make_optimizer(jcfg)
    js = js.replace(params=params, target_params=params,
                    opt_state=tx.init(params))
    batch = batch_of(np.random.default_rng(seed), B)
    jbatch = jax.tree.map(jnp.asarray, batch)
    q = jax.jit(lambda p, b: model.apply({"params": p}, b, train=False))(
        js.params, jbatch["board"])
    after, metrics = jax.jit(
        lambda s, b: jdqn.train_step(jcfg, model, tx, s, b))(js, jbatch)
    adam = after.opt_state.inner_state[0]
    host = functools.partial(jax.tree.map, np.asarray)
    return dict(batch=batch, params=host(js.params), q=np.asarray(q),
                loss=float(metrics["loss"]), after=host(after.params),
                mu=host(adam.mu), nu=host(adam.nu), count=int(adam.count))


def sliced_learner(cases):
    """On a rank of a ``(1, 2)`` grid, for each case: the JAX parameters
    loaded into this rank's slices; the Q-values, one update's loss and
    parameters, gathered; JAX's state after its update carried in
    (``load_jax_train_state``) and gathered back, Adam's moments too."""
    model_group, _ = mesh.grid_groups(1, 2)
    out = {}
    for name, (kw, jax_run) in cases.items():
        cfg = tdqn.DQNConfig(**kw)
        st = tdqn.create_train_state(cfg, "cpu", 0, model_group)
        tmodels.load_flax_params(st.model, jax_run["params"])
        tmodels.load_flax_params(st.target, jax_run["params"])
        st.model.eval()
        with torch.no_grad():
            q = st.model(torch.from_numpy(jax_run["batch"]["board"]))
        loss, _ = tdqn.train_step(cfg, st, to_torch_batch(jax_run["batch"]))
        updated = tmodels.to_flax_params(st.model)
        tdqn.load_jax_train_state(
            st, jax_run["after"], jax_run["params"], jax_run["mu"],
            jax_run["nu"], jax_run["count"], 5e-5, 0, 1)
        agent = ttrain._agent_dict(st)
        names = list(agent["model"])
        moments = {key: {names[i]: s[key].numpy()
                         for i, s in agent["optimizer"]["state"].items()}
                   for key in ttrain.MOMENTS}
        out[name] = dict(
            q=q.numpy(), loss=float(loss), updated=updated,
            sliced=sorted(st.model.sliced),
            carried=tmodels.to_flax_params(st.model),
            target=tmodels.to_flax_params(st.target), moments=moments)
    return out


@pytest.fixture(scope="module")
def sliced_runs():
    jax_runs = {name: jax_update(kw, seed)
                for seed, (name, kw) in enumerate(CASES.items())}
    ranks = spawn(functools.partial(sliced_learner, {
        name: (kw, jax_runs[name]) for name, kw in CASES.items()}))
    return jax_runs, ranks


def assert_trees(got, want, exact, what):
    for name, w in flat_tree(want).items():
        g = flat_tree(got)[name]
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_sliced_learner_update_matches_jax(case, sliced_runs):
    jax_runs, ranks = sliced_runs
    want = jax_runs[case]
    mixed = CASES[case]["hidden"] % 2
    for got in (r[case] for r in ranks):
        assert ("dense.weight" in got["sliced"]) == (not mixed)
        assert "blocks.0.convs.0.weight" in got["sliced"]
        np.testing.assert_allclose(got["q"], want["q"], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
        assert_trees(got["updated"], want["after"], False, "updated")
    # Both model ranks hold the same activations, loss and gathered tree.
    a, b = ranks[0][case], ranks[1][case]
    np.testing.assert_array_equal(a["q"], b["q"])
    assert a["loss"] == b["loss"]
    assert_trees(a["updated"], b["updated"], True, "rank 1")


def test_weights_carry_across_model_ranks_bit_for_bit(sliced_runs):
    jax_runs, ranks = sliced_runs
    for name, want in jax_runs.items():
        whole = tmodels.create_model(tdqn.DQNConfig(**CASES[name]), "meta")
        for got in (r[name] for r in ranks):
            assert_trees(got["carried"], want["after"], True, "params")
            assert_trees(got["target"], want["params"], True, "target")
            for key, tree in (("exp_avg", want["mu"]),
                              ("exp_avg_sq", want["nu"])):
                layout = tmodels.flax_to_torch_layout(whole, tree)
                assert set(got["moments"][key]) == set(layout)
                for n, w in layout.items():
                    np.testing.assert_array_equal(
                        got["moments"][key][n], w.numpy(),
                        err_msg=f"{key} {n}")


def test_run_chunks_on_a_2x2_grid_equals_one_process():
    got = spawn(functools.partial(testkit.run_chunks, 4, 2, 2,
                                  device="cpu", params=True,
                                  **testkit.CONFIG_KW), n=4)
    want = testkit.run_chunks(4, 2, 2, device="cpu", params=True,
                              **testkit.CONFIG_KW)
    assert got[0]["train_steps"] == 2 * testkit.CONFIG_KW["steps_per_chunk"]
    for r in got:
        assert_digests_agree(r, want)
    # Each data row steps its 8 envs; the model ranks of a row run them
    # alike, so every rank reads the same digest.
    assert all(r["param_sum"] == got[0]["param_sum"] for r in got)


def test_dryrun_multichip_runs_a_2x2_mesh(capsys):
    digest = testkit.dryrun_multichip(4, device="cpu")
    assert digest["env_steps"] == 2 * 8 * 2 and digest["launches"] == 0
    assert "dryrun_multichip(4): mesh=(2, 2)" in capsys.readouterr().out


def test_train_loop_on_a_2x2_grid_resumes_at_other_grids(tmp_path):
    ck, log = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    grid = dataclasses.replace(LOOP, model_parallel=2)
    logs = spawn(functools.partial(testkit.train_rank, grid, 10,
                                   checkpoint_dir=ck, log=log), n=4)
    for other in logs[1:]:
        assert_rows_agree(other, logs[0])
    last = logs[0][-1]["episodes"]
    assert last >= 10
    # Model index 0 of data row 1 wrote the row's part; row 0's agent is
    # whole in state.pt.
    step = os.path.join(ck, "steps", str(last))
    assert sorted(os.listdir(step)) == ["rank1.pt", "state.pt"]
    payload = CheckpointManager(ck).read(last)
    assert payload["agent"]["model"]["dense.weight"].shape == (32, 256)
    # eval --checkpoint-dir reads the whole weights as of one process.
    _, module = restore_params_only(ck, None, LOOP.agent, device="cpu")
    for name, w in module.state_dict().items():
        assert torch.equal(w, payload["agent"]["model"][name]), name
    straight = ttrain.train(LOOP, last + 5, "cpu")
    assert_rows_agree(logs[0], straight[:len(logs[0])])

    for name in ("two", "one"):
        shutil.copytree(ck, str(tmp_path / name))
    two = spawn(functools.partial(testkit.train_rank, LOOP, last + 5,
                                  checkpoint_dir=str(tmp_path / "two"),
                                  resume=True))
    one = ttrain.train(LOOP, last + 5, "cpu", ckpt_manager=CheckpointManager(
        str(tmp_path / "one")), resume=True)
    assert one[0]["env_steps"] == logs[0][-1]["env_steps"] + 32 * 8
    for rows in (two[0], two[1], one):
        assert_rows_agree(rows, straight[len(logs[0]):])
