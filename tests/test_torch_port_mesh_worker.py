"""One rank of a gloo group for `tests/test_torch_port_mesh.py`, and the
cases it shares with the single-process references there. No tests
here, and no JAX: the spawned ranks import the port alone.

    python tests/test_torch_port_mesh_worker.py <rank> <world> <mesh> <store> <out_dir>

joins a `world`-rank gloo group on a FileStore at `store`, runs every
case of `run_cases(mesh, ...)` and writes this rank's results to
`<out_dir>/rank<rank>.pt`.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bsarec_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from bsarec_tpu_torch.data.corpus import load_corpus  # noqa: E402
from bsarec_tpu_torch.data.pipeline import SeqRecData  # noqa: E402

H, L, BATCH, LR = 16, 10, 16, 5e-4
V = 64  # item_size of the corpora: divides over 2 and 4 model ranks
FIELDS = dict(max_seq_length=L, hidden_size=H, num_hidden_layers=1, num_attention_heads=2,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
ZOO = ("SASRec", "FMLPRec", "GRU4Rec", "Caser", "DuoRec", "FEARec", "BERT4Rec")
ZOO_FIELDS = {"caser": dict(nh=2, nv=2), "gru4rec": dict(gru_hidden_size=H),
              "duorec": dict(ssl="us_x"), "fearec": dict(ssl="us_x")}
# the functions' inputs: B rows (over the data ranks), V_CE rows of the
# CE table, V_TOPK of the top-k's; held against JAX by the test module
B, V_CE, V_TOPK, K = 8, 64, 128, 10


def write_corpus(path: Path, n_users: int, seed: int) -> Path:
    """A seeded corpus over items [1, V): the last user's last item is V - 1,
    so item_size is V."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for u in range(1, n_users + 1):
            items = rng.integers(1, V, size=rng.integers(4, 9))
            if u == n_users:
                items[-1] = V - 1
            fh.write(f"{u} {' '.join(map(str, items))}\n")
    return path


def make_data(path: Path) -> SeqRecData:
    return SeqRecData(load_corpus(str(path)), L)


def make_trainer(data: SeqRecData, mesh: str, model_type: str = "BSARec", out: Path | None = None,
                 name: str = "run", loss_impl: str = "auto", eval_impl: str = "auto",
                 batch_size: int = BATCH, dropout: float = 0.0, prng: str = "threefry",
                 multihost: bool = False):
    from bsarec_tpu_torch.train.trainer import Trainer

    fields = FIELDS | ZOO_FIELDS.get(model_type.lower(), {}) | dict(
        hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    model_cfg = ModelConfig(model_type=model_type, item_size=data.item_size,
                            num_users=data.corpus.num_users + 1, loss_impl=loss_impl, **fields)
    train_cfg = TrainConfig(lr=LR, batch_size=batch_size, seed=3, device="cpu", mesh=mesh,
                            eval_impl=eval_impl, prng=prng, multihost=multihost)
    out = out or Path(".")
    return Trainer(model_cfg, train_cfg, data, logging.getLogger("mesh_worker"),
                   str(out / f"{name}.ckpt"))


def function_inputs():
    """The functions' global inputs, seeded numpy arrays."""
    rng = np.random.default_rng(11)
    states = rng.normal(size=(B, H)).astype(np.float32)
    table = (0.5 * rng.normal(size=(V_CE, H))).astype(np.float32)
    answers = rng.integers(0, V_CE, size=B)
    answers[:3] = [0, V_CE // 2, V_CE - 1]  # item 0 and shards' first and last rows
    weights = rng.uniform(0.5, 1.5, size=B).astype(np.float32)
    topk_table = rng.normal(size=(V_TOPK, H)).astype(np.float32)
    seen = rng.integers(1, V_TOPK, size=(B, 6)).astype(np.int32)
    seen[:, 0] = V_TOPK // 4  # a shard's local item 0 at m = 4
    seen[:, 1] = V_TOPK // 2  # ... at m = 2 and 4
    seen[:, -2:] = 0
    ids = rng.integers(0, V_CE, size=(B, 5))
    return dict(states=states, table=table, answers=answers.astype(np.int64), weights=weights,
                topk_table=topk_table, seen=seen, ids=ids.astype(np.int64))


def _functions(mesh) -> dict:
    """This rank's share of every parallel function on `function_inputs()`:
    its data rows of the outputs and of ds, its shard's dT."""
    from bsarec_tpu_torch.ops.rank import build_seen_bitmask
    from bsarec_tpu_torch.parallel import embedding, logits

    x = {k: torch.from_numpy(v) for k, v in function_inputs().items()}
    rows_of = mesh.data_slice(B)
    m = mesh.model

    def shard(t):
        r = t.shape[0] // m
        return t[mesh.model_rank * r:(mesh.model_rank + 1) * r].clone()

    out = {}
    w = x["weights"][rows_of]
    for name, fn in (("streaming", logits.sharded_streaming_ce),
                     ("streaming_bf16", lambda *a: logits.sharded_streaming_ce(*a, "bfloat16")),
                     ("dense", logits.sharded_softmax_ce)):
        s = x["states"][rows_of].clone().requires_grad_()
        t = shard(x["table"]).requires_grad_()
        loss = fn(s, t, x["answers"][rows_of], mesh)
        (loss * w).sum().backward()
        out[f"ce_{name}"] = (loss.detach(), s.grad, t.grad)
    _, logz = logits.sharded_streaming_ce(x["states"][rows_of], shard(x["table"]),
                                          x["answers"][rows_of], mesh, return_logz=True)
    out["ce_logz"] = logz
    t = shard(x["topk_table"])
    start = mesh.model_rank * t.shape[0]
    for n_valid in (V_TOPK - 5, 3 * V_TOPK // 4 - 5):
        bitmask = torch.from_numpy(build_seen_bitmask(x["seen"][rows_of].numpy(), t.shape[0],
                                                      start, start == 0))
        out[f"topk_streaming_{n_valid}"] = logits.sharded_streaming_topk(
            x["states"][rows_of], t, bitmask, mesh, k=K, max_valid_items=n_valid)
        out[f"topk_dense_{n_valid}"] = logits.sharded_masked_topk(
            x["states"][rows_of], t, x["seen"][rows_of], mesh, k=K, max_valid_items=n_valid)
    t = shard(x["table"]).requires_grad_()
    emb = embedding.sharded_embedding_lookup(t, x["ids"][rows_of], mesh)
    (emb ** 2).sum().backward()
    out["lookup"] = (emb.detach(), t.grad)
    return out


def _bsarec_run(data, mesh_spec, out, impl) -> dict:
    """BSARec: two epochs, then save -> load, install_params, a snapshot ->
    resume -> the third epoch, and the export; every number the test
    holds against the single run."""
    from bsarec_tpu_torch.train import checkpoint as ckpt

    tr = make_trainer(data, mesh_spec, out=out, name=f"bsarec_{impl}", loss_impl=impl,
                      eval_impl=impl)
    res = {"impls": (tr.model_cfg.loss_impl, tr.eval_impl), "losses": [], "valid": []}
    for epoch in range(2):
        res["losses"].append(tr.train(epoch))
        res["valid"].append(tr.evaluate_sums("valid"))
    tr.save()
    res["saved"] = ckpt.load_params(tr.checkpoint_path)
    tr.save_state(1)
    res["state"] = ckpt.load_train_state(tr.state_path)
    tr.load()
    res["valid_after_load"] = tr.evaluate_sums("valid")
    tr.install_params(res["saved"])
    res["valid_after_install"] = tr.evaluate_sums("valid")
    res["topk"] = tr.export_topk("test")
    res["loss_epoch2"] = tr.train(2)
    resumed = make_trainer(data, mesh_spec, out=out, name=f"bsarec_{impl}", loss_impl=impl,
                           eval_impl=impl)
    res["resume_epoch"] = resumed.resume()
    res["loss_epoch2_resumed"] = resumed.train(2)
    return res


def _zoo_step(data, mesh_spec, model_type) -> dict:
    """One epoch of one step (the batch covers every sample): the loss, the
    averaged gradients and the parameters after Adam, in the single-card
    layout."""
    tr = make_trainer(data, mesh_spec, model_type=model_type, batch_size=BATCH)
    assert tr.steps_per_epoch == 1
    loss = tr.train(0)
    grads = {k: p.grad.detach().clone() for k, p in tr.model.named_parameters()
             if p.grad is not None}
    if tr.table_sharded:
        grads["item_embeddings.weight"] = tr._gather_rows(grads["item_embeddings.weight"])
    return {"loss": loss, "grads": grads, "params": tr.full_state_dict(),
            "impl": tr.model_cfg.loss_impl, "table_sharded": tr.table_sharded}


def _dropout_masks(data, mesh_spec) -> dict:
    """A train-mode SASRec forward of the same inputs on every rank, with
    nn.Dropout (torch's default generators, seeded per data rank) and with
    the fused dropout's plain version (the step's seed words per data rank)."""
    from bsarec_tpu_torch.train.loop import data_rank_seeds

    ids = torch.from_numpy(data.valid.input_ids[:BATCH]).long()
    out = {}
    tr = make_trainer(data, mesh_spec, model_type="SASRec", dropout=0.5)
    tr.model.train()
    out["nn"] = tr.model(ids).detach()
    os.environ["BSAREC_DROPOUT"] = "pallas"
    try:
        tr = make_trainer(data, mesh_spec, model_type="SASRec", dropout=0.5, prng="rbg")
    finally:
        os.environ.pop("BSAREC_DROPOUT")
    seeds = data_rank_seeds(torch.tensor([[12345, 67890]], dtype=torch.int64), tr.mesh)
    tr.model.train()
    tr.model.dropout_state.begin_step(seeds[0])
    out["fused"] = tr.model(ids).detach()
    return out


def _host_fed(data, one_step, mesh_spec, out) -> dict:
    """`--multihost` under the layout: BSARec's two epochs (streaming, as
    `_bsarec_run`'s first two), and one SASRec step (negatives drawn for
    the global batch, this rank's rows kept) both host-fed and
    device-resident: the losses, valid sums and parameters after the step."""
    tr = make_trainer(data, mesh_spec, out=out, name="host_fed", loss_impl="streaming",
                      eval_impl="streaming", multihost=True)
    res = {"bsarec": {"losses": [], "valid": [], "train_dev": tr._train_dev}}
    for epoch in range(2):
        res["bsarec"]["losses"].append(tr.train(epoch))
        res["bsarec"]["valid"].append(tr.evaluate_sums("valid"))
    for name, on in (("mesh", False), ("host", True)):
        tr = make_trainer(one_step, mesh_spec, model_type="SASRec", multihost=on)
        assert tr.steps_per_epoch == 1
        res[f"sasrec_{name}"] = {"loss": tr.train(0), "params": tr.full_state_dict(),
                                 "train_dev": tr._train_dev}
    return res


def main_argv(corpus_dir: Path, out: Path, mesh_spec: str) -> list[str]:
    """`main`'s flags of the CLI case: BSARec at the module's widths,
    dropout 0, the corpus `toy.txt` of `corpus_dir`, files in `out`."""
    argv = ["--device", "cpu", "--data_dir", str(corpus_dir), "--data_name", "toy",
            "--output_dir", str(out), "--train_name", "cli", "--hidden_size", str(H),
            "--num_hidden_layers", "1", "--max_seq_length", str(L), "--batch_size", str(BATCH),
            "--hidden_dropout_prob", "0", "--attention_probs_dropout_prob", "0"]
    return argv + (["--mesh", mesh_spec] if mesh_spec else [])


def _main_run(corpus_dir: Path, out: Path, mesh_spec: str, serving: bool) -> dict:
    """`main` through every file-writing flag: one epoch with --export_topk
    and --dump_seqout, --resume to a second, and with `serving` --do_eval
    --export_serving; the files land in `out` (rank 0 writes them)."""
    from bsarec_tpu_torch.main import main

    argv = main_argv(corpus_dir, out, mesh_spec)
    res = {"first": main(argv + ["--epochs", "1", "--export_topk", str(out / "cli_topk1.npy"),
                                 "--dump_seqout", str(out / "seqout")]),
           "resumed": main(argv + ["--epochs", "2", "--resume",
                                   "--export_topk", str(out / "cli_topk2.npy")])}
    if serving:
        main(argv + ["--do_eval", "--load_model", "cli", "--export_serving",
                     str(out / "cli_scorer.pt2")])
    return res


def run_cases(mesh_spec: str, workdir: Path, shared: Path, zoo: bool, dropout: bool) -> dict:
    """Every case of one layout (`mesh_spec` "" for the single run): the
    corpora in this rank's `workdir`, the run's files in `shared`, which
    every rank reads."""
    from bsarec_tpu_torch.core.mesh import make_mesh, parse_mesh_spec

    torch.set_num_threads(1)
    data = make_data(write_corpus(workdir / "toy.txt", 30, seed=1))
    res = {}
    if mesh_spec:
        res["functions"] = _functions(make_mesh(parse_mesh_spec(mesh_spec), "cpu"))
    res["bsarec"] = {impl: _bsarec_run(data, mesh_spec, shared, impl)
                     for impl in ("streaming", "dense")}
    if zoo:  # the two-rank layouts and the single run
        res["main"] = _main_run(workdir, shared, mesh_spec, serving=mesh_spec != "data:2,model:1")
    one_step = make_data(write_corpus(workdir / "one_step.txt", 4, seed=2))
    res["host_fed"] = _host_fed(data, one_step, mesh_spec, shared)
    if zoo:
        res["zoo"] = {mt: _zoo_step(one_step, mesh_spec, mt) for mt in ZOO}
    if dropout:
        res["dropout"] = _dropout_masks(data, mesh_spec)
    return res


def main(argv) -> None:
    import torch.distributed as dist

    rank, world, mesh_spec, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3], Path(argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    workdir, shared = out / f"rank{rank}", out / "shared"
    workdir.mkdir(parents=True, exist_ok=True)
    shared.mkdir(exist_ok=True)
    try:
        res = run_cases(mesh_spec, workdir, shared, zoo=world == 2, dropout=world == 4)
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
