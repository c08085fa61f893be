"""`--mesh` over torch.distributed on the CPU: three gloo groups of spawned
ranks (`tests/test_torch_port_mesh_worker.py`), data:1,model:2,
data:2,model:1 and data:2,model:2, each started once for the module and
running every case, held against JAX's functions and against the port's
single process:

- the parallel functions (the sharded streaming and dense CE with their
  gradients, the streaming and dense top-k, the lookup) against JAX's
  (`bsarec_tpu/parallel/`, `ops/topk.py`, `jax.grad`);
- `Trainer`: BSARec two epochs with dropout 0 in streaming and dense,
  losses within MESH_LOSS_RTOL and metrics within MESH_METRIC_ATOL of the
  single run (`bsarec_tpu_torch/parity.py`); save -> load, install_params,
  resume and the top-k export; the files in the single-card layout;
- one Adam step of every other zoo model in both two-rank layouts;
- `--multihost` in every layout (BSARec's two epochs, one SASRec step)
  bit-equal to the same layout's device-resident run;
- the dropout masks: the same within a model group, apart across data
  ranks (data:2,model:2).

Each rank runs one torch thread. The groups start together and take
about ten seconds; the single-process references run meanwhile."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_port_mesh_worker as worker
from bsarec_tpu.ops.topk import masked_topk as jax_masked_topk
from bsarec_tpu_torch import parity
from bsarec_tpu_torch.core.mesh import Mesh, MeshConfig, data_rows, parse_mesh_spec
from bsarec_tpu_torch.ops.topk import metrics_from_sums
from bsarec_tpu_torch.parallel import logits as plog

LAYOUTS = {"data:1,model:2": 2, "data:2,model:1": 2, "data:2,model:2": 4}
TWO_RANK = ("data:1,model:2", "data:2,model:1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{layout: [rank results]} of the three groups, and "single": the same
    cases in this process without a mesh."""
    root = tmp_path_factory.mktemp("mesh")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = {}
    for spec, world in LAYOUTS.items():
        out = root / spec.replace(":", "").replace(",", "_")
        out.mkdir()
        procs[spec] = (out, [subprocess.Popen(
            [sys.executable, worker.__file__, str(r), str(world), spec, str(out / "store"),
             str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)])
    single_dir = root / "single"
    single_dir.mkdir()
    results = {"single": worker.run_cases("", single_dir, single_dir, zoo=True, dropout=False),
               "single_dir": single_dir, "dirs": {spec: out for spec, (out, _) in procs.items()}}
    for spec, (out, group) in procs.items():
        logs = [p.communicate(timeout=600)[0] for p in group]
        failed = [(r, log[-4000:]) for r, (p, log) in enumerate(zip(group, logs)) if p.returncode]
        assert not failed, f"{spec}: {failed}"
        results[spec] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                         for r in range(len(group))]
    return results


def _layout(spec):
    cfg = parse_mesh_spec(spec)
    return cfg.data, cfg.model


def _rows(ranks, spec, get):
    """The data ranks' pieces of a per-row output, in row order (model rank
    0's; every model rank holds the same)."""
    d, m = _layout(spec)
    return torch.cat([get(ranks[i * m]) for i in range(d)])


def _table(ranks, spec, get):
    """The shards' pieces of a table gradient: summed over the data ranks,
    concatenated in shard order."""
    d, m = _layout(spec)
    return torch.cat([sum(get(ranks[i * m + s]) for i in range(d)) for s in range(m)])


# ---- the functions against JAX ------------------------------------------------------


def _jax_ce(x, bf16=False):
    """JAX's per-row CE, logZ and the gradients of sum(weights * loss)."""
    a = jnp.asarray(x["answers"])

    def rows(s, t):
        if bf16:
            s, t = s.astype(jnp.bfloat16), t.astype(jnp.bfloat16)
        logits = jnp.einsum("bh,vh->bv", s, t, preferred_element_type=jnp.float32)
        logz = jax.nn.logsumexp(logits, axis=-1)
        return logz - jnp.take_along_axis(logits, a[:, None], axis=-1)[:, 0], logz

    (loss, logz), vjp = jax.vjp(rows, jnp.asarray(x["states"]), jnp.asarray(x["table"]))
    ds, dt = vjp((jnp.asarray(x["weights"]), jnp.zeros_like(logz)))
    return [np.asarray(y) for y in (loss, logz, ds, dt)]


@pytest.mark.parametrize("spec", list(LAYOUTS))
def test_ce_through_the_group_matches_jax(runs, spec):
    """The sharded streaming CE (fp32) and the dense pair: per-row loss,
    logZ, ds and dT (the data ranks' dT summed, as the loop's average
    does) against JAX; the bf16 form against the port's one-process
    composition of the same shards."""
    ranks, x = runs[spec], worker.function_inputs()
    loss, logz, ds, dt = _jax_ce(x)
    for name in ("ce_streaming", "ce_dense"):
        f = lambda r, i: r["functions"][name][i]  # noqa: E731
        np.testing.assert_allclose(_rows(ranks, spec, lambda r: f(r, 0)), loss,
                                   **parity.SHARD_LOSS_TOL)
        np.testing.assert_allclose(_rows(ranks, spec, lambda r: f(r, 1)), ds,
                                   **parity.SHARD_GRAD_TOL)
        np.testing.assert_allclose(_table(ranks, spec, lambda r: f(r, 2)), dt,
                                   **parity.SHARD_GRAD_TOL)
    np.testing.assert_allclose(_rows(ranks, spec, lambda r: r["functions"]["ce_logz"]), logz,
                               **parity.SHARD_LOSS_TOL)
    _, m = _layout(spec)
    s, t, a = (torch.from_numpy(x[k]) for k in ("states", "table", "answers"))
    want, want_logz = plog.streaming_ce_over_shards(s, list(t.chunk(m)), a, "bfloat16")
    want_ds, want_dt = plog.streaming_ce_grads_over_shards(
        s, list(t.chunk(m)), a, want_logz, torch.from_numpy(x["weights"]), "bfloat16")
    f = lambda r, i: r["functions"]["ce_streaming_bf16"][i]  # noqa: E731
    torch.testing.assert_close(_rows(ranks, spec, lambda r: f(r, 0)), want,
                               **parity.SHARD_LOSS_TOL)
    errs = parity.grad_errors(_rows(ranks, spec, lambda r: f(r, 1)),
                              _table(ranks, spec, lambda r: f(r, 2)), want_ds, want_dt, a,
                              worker.V_CE)
    assert max(errs.values()) <= parity.BF16_GRAD_TOL, errs


@pytest.mark.parametrize("spec", list(LAYOUTS))
def test_topk_and_lookup_through_the_group_match_jax(runs, spec):
    """Both top-k forms against JAX's `masked_topk` of the whole table (ids
    past n_valid at -inf; a shard past n_valid at m = 4); the lookup and its
    gradient against JAX's gather and `jax.grad`, row 0 taking none from
    id 0 (`padding_idx`)."""
    ranks, x = runs[spec], worker.function_inputs()
    scores = jnp.asarray(x["states"]) @ jnp.asarray(x["topk_table"]).T
    for n_valid in (worker.V_TOPK - 5, 3 * worker.V_TOPK // 4 - 5):
        masked = scores.at[:, n_valid:].set(-jnp.inf)
        want_v, want_i = jax_masked_topk(masked, jnp.asarray(x["seen"]), k=worker.K)
        for form in ("streaming", "dense"):
            key = f"topk_{form}_{n_valid}"
            got_v = _rows(ranks, spec, lambda r: r["functions"][key][0])
            got_i = _rows(ranks, spec, lambda r: r["functions"][key][1])
            np.testing.assert_allclose(got_v, np.asarray(want_v), rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(got_i, np.asarray(want_i))
    ids = jnp.asarray(x["ids"])
    table = jnp.asarray(x["table"])
    emb, grad = jax.value_and_grad(lambda t: jnp.sum(jnp.take(t, ids, axis=0) ** 2))(table)
    got = _rows(ranks, spec, lambda r: r["functions"]["lookup"][0])
    np.testing.assert_array_equal(got, np.asarray(jnp.take(table, ids, axis=0)))
    got_grad = _table(ranks, spec, lambda r: r["functions"]["lookup"][1])
    np.testing.assert_allclose(got_grad[1:], np.asarray(grad)[1:], rtol=1e-6, atol=1e-6)
    assert not got_grad[0].any()


# ---- Trainer against the single run ----------------------------------------------


@pytest.mark.parametrize("impl", ["streaming", "dense"])
@pytest.mark.parametrize("spec", list(LAYOUTS))
def test_bsarec_trains_as_the_single_run(runs, spec, impl):
    """Two epochs at dropout 0: every rank's epoch losses within
    MESH_LOSS_RTOL and its valid metrics within MESH_METRIC_ATOL of the
    single run's, on the impl the vocab-sharded rule picks."""
    want = runs["single"]["bsarec"][impl]
    _, m = _layout(spec)
    for r in runs[spec]:
        got = r["bsarec"][impl]
        want_impl = {"streaming": "sharded_streaming", "dense": "sharded_dense"}[impl]
        assert got["impls"] == ((want_impl, want_impl) if m > 1 else (impl, impl))
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=parity.MESH_LOSS_RTOL)
        for g, w in zip(got["valid"], want["valid"]):
            assert g[-1] == w[-1]  # users
            mg, mw = metrics_from_sums(g), metrics_from_sums(w)
            for k in mw:
                assert abs(mg[k] - mw[k]) <= parity.MESH_METRIC_ATOL, (k, mg[k], mw[k])


@pytest.mark.parametrize("spec", list(LAYOUTS))
def test_files_keep_the_single_card_layout_and_round_trip(runs, spec):
    """`save` writes the full table (rank 0, gathered), the snapshot holds
    the full table's Adam moments; `load` and `install_params` give back
    the same valid sums; `resume` continues at epoch 2 with the third
    epoch's loss bit-equal to the uninterrupted run's; the export equals
    the single run's."""
    for impl in ("streaming", "dense"):
        want = runs["single"]["bsarec"][impl]
        for r in runs[spec]:
            got = r["bsarec"][impl]
            assert got["saved"].keys() == want["saved"].keys()
            for k, v in want["saved"].items():
                assert got["saved"][k].shape == v.shape, k
                torch.testing.assert_close(got["saved"][k], v, rtol=1e-3, atol=1e-5)
            state = got["state"]
            assert state["params"]["item_embeddings.weight"].shape == (worker.V, worker.H)
            want_moments = want["state"]["opt_state"]["state"]
            assert state["opt_state"]["state"].keys() == want_moments.keys()
            for i, moments in state["opt_state"]["state"].items():
                for k in ("exp_avg", "exp_avg_sq"):
                    assert moments[k].shape == want_moments[i][k].shape, (i, k)
            np.testing.assert_array_equal(got["valid_after_load"], got["valid"][-1])
            np.testing.assert_array_equal(got["valid_after_install"], got["valid"][-1])
            assert got["resume_epoch"] == 2
            assert got["loss_epoch2_resumed"] == got["loss_epoch2"]
            np.testing.assert_array_equal(got["topk"], want["topk"])


@pytest.mark.parametrize("spec", TWO_RANK)
def test_main_files_equal_the_single_runs(runs, spec):
    """`main --mesh` through --export_topk, --dump_seqout, --resume and
    --export_serving: the scores of every rank, and each file (written once,
    by rank 0, with the full table) against the single run's."""
    from bsarec_tpu_torch.serving import load_scorer
    from bsarec_tpu_torch.utils.visualize import load_sequence_outputs

    single, shared = runs["single_dir"], runs["dirs"][spec] / "shared"
    for r in runs[spec]:
        for key in ("first", "resumed"):
            np.testing.assert_allclose(r["main"][key], runs["single"]["main"][key],
                                       atol=parity.MESH_METRIC_ATOL)
    for name in ("cli_topk1.npy", "cli_topk2.npy"):
        np.testing.assert_array_equal(np.load(shared / name), np.load(single / name))
    got = torch.load(shared / "cli.ckpt")
    for k, v in torch.load(single / "cli.ckpt").items():
        torch.testing.assert_close(got[k], v, rtol=1e-3, atol=1e-5, msg=k)
    want_dumps = load_sequence_outputs(str(single / "seqout" / "toy_BSARec"), n_layers=1)
    got_dumps = load_sequence_outputs(str(shared / "seqout" / "toy_BSARec"), n_layers=1)
    assert len(got_dumps) == len(want_dumps)
    for g, w in zip(got_dumps, want_dumps):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    if spec == "data:1,model:2":  # the export gathers the sharded table
        ids = worker.make_data(shared.parent / "rank0" / "toy.txt").test.input_ids[:8]
        want = load_scorer(str(single / "cli_scorer.pt2"), "cpu").topk(ids)
        np.testing.assert_array_equal(load_scorer(str(shared / "cli_scorer.pt2"), "cpu").topk(ids),
                                      want)


@pytest.mark.parametrize("model_type", worker.ZOO)
@pytest.mark.parametrize("spec", TWO_RANK)
def test_zoo_model_steps_as_the_single_run(runs, spec, model_type):
    """One Adam step of each zoo model: the loss, every averaged gradient
    (the table's gathered) and every parameter after the step against the
    single run's. BERT4Rec keeps its table whole and the dense CE."""
    want = runs["single"]["zoo"][model_type]
    _, m = _layout(spec)
    for r in runs[spec]:
        got = r["zoo"][model_type]
        sharded = m > 1 and model_type != "BERT4Rec"
        assert got["table_sharded"] == sharded
        if model_type == "BERT4Rec" and m > 1:
            assert got["impl"] == "dense"
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=parity.SHARD_LOSS_TOL["rtol"])
        assert got["grads"].keys() == want["grads"].keys()
        for k, g in want["grads"].items():
            torch.testing.assert_close(got["grads"][k], g, **parity.SHARD_GRAD_TOL, msg=k)
            delta = (got["params"][k] - want["params"][k]).abs()
            clear = g.abs() > parity.MESH_GRAD_NOISE * g.abs().max()
            assert float(torch.where(clear, delta, 0.0).max()) <= parity.MESH_STEP_PARAM_ATOL, k
            assert float(delta.max()) <= 2 * worker.LR + parity.MESH_STEP_PARAM_ATOL, k


@pytest.mark.parametrize("spec", list(LAYOUTS))
def test_host_fed_runs_equal_the_mesh_runs(runs, spec):
    """`--multihost` under the layout, every rank: BSARec's two epoch losses
    and valid sums bit-equal to the same layout's device-resident run and
    within MESH_LOSS_RTOL of the single run; one SASRec step (at data:2 each
    rank keeps its rows of the global batch's negatives) with the loss and
    every parameter bit-equal to the device-resident step's, the loss
    within MESH_LOSS_RTOL of the single run's; no training set on the
    device."""
    single = runs["single"]["host_fed"]
    for r in runs[spec]:
        got, mesh_run = r["host_fed"], r["bsarec"]["streaming"]
        assert got["bsarec"]["train_dev"] is None
        assert got["bsarec"]["losses"] == mesh_run["losses"][:2]
        for g, w in zip(got["bsarec"]["valid"], mesh_run["valid"]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(got["bsarec"]["losses"], single["bsarec"]["losses"],
                                   rtol=parity.MESH_LOSS_RTOL)
        host, mesh = got["sasrec_host"], got["sasrec_mesh"]
        assert host["train_dev"] is None and mesh["train_dev"] is not None
        assert host["loss"] == mesh["loss"]
        assert host["params"].keys() == mesh["params"].keys()
        for k, v in mesh["params"].items():
            assert torch.equal(host["params"][k], v), k
        np.testing.assert_allclose(host["loss"], single["sasrec_host"]["loss"],
                                   rtol=parity.MESH_LOSS_RTOL)


def test_host_fed_single_run_equals_the_device_resident_one(runs):
    """The same cases without a mesh: bit-equal to the single run's own
    device-resident BSARec epochs and SASRec step."""
    single = runs["single"]
    got = single["host_fed"]
    assert got["bsarec"]["losses"] == single["bsarec"]["streaming"]["losses"][:2]
    assert got["sasrec_host"]["loss"] == got["sasrec_mesh"]["loss"]
    for k, v in got["sasrec_mesh"]["params"].items():
        assert torch.equal(got["sasrec_host"]["params"][k], v), k


def test_dropout_masks_per_data_rank(runs):
    """data:2,model:2, SASRec at dropout 0.5 on the same inputs everywhere:
    the ranks of a model group draw the same masks (nn.Dropout and the
    fused dropout's plain version), the two data ranks other ones."""
    ranks = runs["data:2,model:2"]
    for path in ("nn", "fused"):
        out = [r["dropout"][path] for r in ranks]
        assert torch.equal(out[0], out[1]) and torch.equal(out[2], out[3]), path
        assert not torch.allclose(out[0], out[2]), path


# ---- the rules, in this process ------------------------------------------------------


def test_mesh_spec_and_the_world_size():
    """`parse_mesh_spec` as JAX's; a mesh whose size is not the world's
    raises (JAX takes the first data * model devices: a pinned
    divergence); a global batch that does not split over the data ranks
    raises."""
    assert parse_mesh_spec("") is None
    assert parse_mesh_spec("auto") == MeshConfig()
    assert parse_mesh_spec("data:2,model:4") == MeshConfig(data=2, model=4)
    assert MeshConfig().resolve(4) == (4, 1)
    assert MeshConfig(model=2).resolve(4) == (2, 2)
    for cfg, world in ((MeshConfig(data=2, model=2), 8), (MeshConfig(data=1, model=2), 1)):
        with pytest.raises(ValueError, match="ranks"):
            cfg.resolve(world)
    # a rank's rows of a global batch: data rank 1 of 2 takes the second half
    mesh = Mesh.__new__(Mesh)
    mesh.data, mesh.data_rank = 2, 1
    assert torch.equal(data_rows(torch.arange(6), mesh), torch.tensor([3, 4, 5]))
    with pytest.raises(ValueError, match="does not split"):
        data_rows(torch.arange(5), mesh)


def test_main_mesh_one_rank_equals_the_plain_run(tmp_path):
    """`main --mesh data:1,model:1 --device cpu` makes a one-rank gloo group,
    trains as the plain run does, bit for bit, and leaves no group behind;
    a mesh that needs two ranks raises in it."""
    from bsarec_tpu_torch.main import main as port_main

    worker.write_corpus(tmp_path / "toy.txt", 30, seed=1)
    common = ["--device", "cpu", "--data_dir", str(tmp_path), "--data_name", "toy",
              "--output_dir", str(tmp_path), "--epochs", "2", "--hidden_size", "16",
              "--num_hidden_layers", "1", "--max_seq_length", "10", "--batch_size", "16"]
    plain = port_main([*common, "--train_name", "plain"])
    mesh = port_main([*common, "--train_name", "mesh", "--mesh", "data:1,model:1"])
    assert mesh == plain and not dist.is_initialized()
    a, b = (torch.load(tmp_path / f"{n}.ckpt") for n in ("plain", "mesh"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    log = Path(tmp_path / "mesh.log").read_text()
    assert "mesh: {'data': 1, 'model': 1} (cpu" in log
    with pytest.raises(ValueError, match="needs 2 ranks"):
        port_main([*common, "--train_name", "bad", "--mesh", "data:1,model:2"])
    assert not dist.is_initialized()
