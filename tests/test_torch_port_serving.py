"""The port's serving export (`bsarec_tpu_torch/serving.py`, `serve.py`,
`main --export_serving`) against the JAX package's (`bsarec_tpu/serving.py`)
on the same trained weights, at `tests/test_serving.py`'s size (30 items,
hidden 16, 1 layer).

Both artifacts mask seen ids and the padding id 0 to -inf and break ties
towards the smallest id, so ranked ids are compared exactly, the -inf
fill of rows with fewer than 20 unmasked items included. The two models'
scores differ only by fp32 summation order (~1e-7 here); where two
scores lie closer than that an id pair could swap, and `_assert_same_ids`
then accepts a swap only between ids whose scores agree within
SCORE_TOL. On the CPU the `bitmask` layout runs the rank kernel's plain
version through the custom op; the kernel itself is held against it in
`tests/test_torch_port_cuda.py` and `chip_smoke.py`."""

import http.client
import json
import logging
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu import serve as jax_serve
from bsarec_tpu import serving as jax_serving
from bsarec_tpu.config import ModelConfig as JaxModelConfig
from bsarec_tpu.config import TrainConfig as JaxTrainConfig
from bsarec_tpu.data.corpus import Corpus as JaxCorpus
from bsarec_tpu.data.pipeline import SeqRecData as JaxSeqRecData
from bsarec_tpu.ops.topk import masked_topk as jax_eval_masked_topk
from bsarec_tpu.train.trainer import Trainer as JaxTrainer
from bsarec_tpu_torch import serve, serving
from bsarec_tpu_torch.config import ModelConfig
from bsarec_tpu_torch.models import build_model
from bsarec_tpu_torch.ops import rank
from bsarec_tpu_torch.ops import serving_topk
from bsarec_tpu_torch.train.jax_import import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
MAX_LEN, N_ITEMS = 10, 30
# the artifacts' seen width: wider than the test split's (10), so that a
# row can mask 17 of the 31 ids and keep fewer than 20 unmasked
SEEN_WIDTH = 16
# two fp32 scores of H=16 terms summed in another order by XLA and torch
SCORE_TOL = 1e-5


def _corpus_seqs(n_users=60, n_items=N_ITEMS, seed=0):
    """`tests/test_serving.py:_corpus`: histories of 5-11 items."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_users):
        start = rng.integers(1, n_items - 1)
        seqs.append([int((start + i) % (n_items - 1) + 1) for i in range(rng.integers(5, 12))])
    return seqs


def _logger():
    logger = logging.getLogger("test_torch_port_serving")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One trained tiny JAX BSARec, its weights in a port model, and both
    packages' default (bitmask) artifacts."""
    tmp = tmp_path_factory.mktemp("port_serving")
    corpus = JaxCorpus(user_seq=_corpus_seqs(), max_item=N_ITEMS)
    data = JaxSeqRecData(corpus, max_len=MAX_LEN)
    fields = dict(model_type="bsarec", item_size=corpus.item_size, num_users=corpus.num_users + 1,
                  max_seq_length=MAX_LEN, hidden_size=16, num_hidden_layers=1,
                  num_attention_heads=1, c=3, alpha=0.7)
    t = JaxTrainer(JaxModelConfig(**fields),
                   JaxTrainConfig(lr=0.01, batch_size=32, epochs=1, seed=3),
                   data, _logger(), str(tmp / "s.ckpt"))
    t.train(0)
    model = build_model(ModelConfig(**fields))
    model.load_state_dict(params_from_jax(jax.device_get(t.params)))
    model.eval()
    item_size, seen_width = fields["item_size"], SEEN_WIDTH
    assert data.test.seen_items.shape[1] < seen_width
    jax_path, port_path = str(tmp / "scorer.jaxexp"), str(tmp / "scorer.pt2")
    jax_serving.export_scorer(t.model, t.params, item_size, MAX_LEN, seen_width, jax_path)
    meta = serving.export_scorer(model, item_size, MAX_LEN, seen_width, port_path)
    return dict(t=t, data=data, model=model, item_size=item_size, seen_width=seen_width,
                jax=jax_serving.load_scorer(jax_path), port=serving.load_scorer(port_path, "cpu"),
                port_path=port_path, meta=meta, tmp=tmp)


def _logits(trained, input_ids):
    with torch.no_grad():
        state = trained["model"].predict(torch.from_numpy(np.asarray(input_ids)).long())[:, -1]
        return (state @ trained["model"].item_table[:trained["item_size"]].T).numpy()


def _assert_same_ids(got, want, logits):
    """Ids equal, or swapped only between ids whose scores agree within
    SCORE_TOL (a near-tie that summation order can flip)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = got != want
    if diff.any():
        rows = np.nonzero(diff)[0]
        gs = np.take_along_axis(logits[rows], got[diff][:, None].astype(np.int64), 1)
        ws = np.take_along_axis(logits[rows], want[diff][:, None].astype(np.int64), 1)
        np.testing.assert_allclose(gs, ws, atol=SCORE_TOL, rtol=0)


def _split(trained):
    """The test split's inputs, user ids and seen lists, the lists widened
    to SEEN_WIDTH and every third filled with 16 distinct ids."""
    test = trained["data"].test
    seen = np.zeros((test.num_users, SEEN_WIDTH), np.int32)
    seen[:, :test.seen_items.shape[1]] = test.seen_items
    rng = np.random.default_rng(1)
    for u in range(0, test.num_users, 3):
        seen[u] = rng.permutation(np.arange(1, trained["item_size"]))[:SEEN_WIDTH]
    return test.input_ids, np.arange(test.num_users, dtype=np.int32), seen


@pytest.mark.parametrize("impl", serving.IMPLS)
@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp32", "int8"])
def test_artifact_matches_jax_artifact(trained, tmp_path, impl, quant):
    """Each layout, fp32 and int8: the port's artifact ranks the whole test
    split (60 users in one batch) as the JAX artifact of the same layout
    does, fill of the rows with fewer than 20 unmasked items included, and
    keeps the serving contract."""
    ids, uids, seen = _split(trained)
    if impl == "bitmask" and quant is None:
        port, jax_scorer = trained["port"], trained["jax"]
    else:
        chunk = 8 if impl == "chunked" else 65536
        jpath, ppath = str(tmp_path / "j.jaxexp"), str(tmp_path / "p.pt2")
        jax_serving.export_scorer(trained["t"].model, trained["t"].params, trained["item_size"],
                                  MAX_LEN, trained["seen_width"], jpath, quant=quant, impl=impl,
                                  item_chunk=chunk)
        meta = serving.export_scorer(trained["model"], trained["item_size"], MAX_LEN,
                                     trained["seen_width"], ppath, quant=quant, impl=impl,
                                     item_chunk=chunk)
        assert (meta["impl"], meta["quant"]) == (impl, quant or "none")
        port, jax_scorer = serving.load_scorer(ppath, "cpu"), jax_serving.load_scorer(jpath)
    got = port.topk(ids, uids, seen)
    want = jax_scorer.topk(ids, uids, seen)
    assert got.shape == (len(ids), 20) and got.dtype == np.int32
    _assert_same_ids(got, want, _logits(trained, ids))
    # the -inf fill: rows whose unmasked items are fewer than 20 end in
    # 0 and then their seen ids ascending, as lax.top_k orders them
    n_masked = np.array([len(set(s.tolist()) | {0}) for s in seen])
    short = np.nonzero(trained["item_size"] - n_masked < 20)[0]
    assert len(short) > 0
    for u in short:
        n_free = trained["item_size"] - n_masked[u]
        masked = sorted(set(seen[u].tolist()) | {0})
        np.testing.assert_array_equal(got[u, n_free:], masked[:20 - n_free])
    for u in range(len(ids)):
        n_free = min(20, trained["item_size"] - n_masked[u])
        assert not set(got[u, :n_free]) & (set(seen[u].tolist()) | {0}), u


def test_scorer_batch_polymorphic_and_defaults(trained):
    """One export serves batches 1, 3 and 7; omitted user_ids and
    seen_items default to zeros (mask only the padding column)."""
    ids = trained["data"].test.input_ids
    for b in (1, 3, 7):
        got = trained["port"].topk(ids[:b])
        assert got.shape == (b, 20)
        _assert_same_ids(got, trained["jax"].topk(ids[:b]), _logits(trained, ids[:b]))
    assert trained["port"].max_len == MAX_LEN
    assert trained["port"].seen_width == trained["seen_width"]
    assert trained["meta"]["bytes"] == os.path.getsize(trained["port_path"])


def test_scorer_calls_from_threads(trained):
    """The HTTP host calls one Scorer from many threads: 12 threads x 5
    calls at batches 1-12, with a short switch interval, each give the
    single-threaded answer."""
    ids, uids, seen = _split(trained)
    port = trained["port"]
    want = {b: port.topk(ids[:b], uids[:b], seen[:b]) for b in range(1, 13)}
    bad = []

    def work(b):
        for _ in range(5):
            if not np.array_equal(port.topk(ids[:b], uids[:b], seen[:b]), want[b]):
                bad.append(b)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(b,)) for b in range(1, 13)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not bad


def test_int8_logits_close_to_fp32_and_to_jax():
    """Per-row symmetric int8 keeps the logits within ~1% of fp32 (JAX's
    test bound), and the port's int8 logits equal JAX's: the same scales,
    exact int32-valued sums, the same two scale products."""
    rng = np.random.default_rng(0)
    state = rng.normal(size=(8, 64)).astype(np.float32)
    table = rng.normal(size=(512, 64)).astype(np.float32)
    got = serving.int8_logits(torch.from_numpy(state), torch.from_numpy(table)).numpy()
    want = state @ table.T
    assert np.abs(got - want).max() < 0.02 * np.abs(want).max()
    jax_got = np.asarray(jax_serving.int8_logits(jnp.asarray(state), jnp.asarray(table)))
    np.testing.assert_array_equal(got, jax_got)
    q, s = serving.quantize_rows(torch.from_numpy(table))
    jq, js = jax_serving.quantize_rows(jnp.asarray(table))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_int8_artifact_tracks_fp32(trained, tmp_path):
    """The int8 artifact agrees with the fp32 one on the top item of at
    least 90% of the test users (`tests/test_serving.py`'s bound)."""
    path = str(tmp_path / "int8.pt2")
    serving.export_scorer(trained["model"], trained["item_size"], MAX_LEN, trained["seen_width"],
                          path, quant="int8")
    ids, _, seen = _split(trained)
    q = serving.load_scorer(path, "cpu").topk(ids, None, seen)
    f = trained["port"].topk(ids, None, seen)
    assert (q[:, 0] == f[:, 0]).mean() >= 0.9


@pytest.mark.parametrize("kwargs", [
    {}, {"mask_history": False}, {"seen_items": [[3, 4], [], [1, 2, 3, 4, 5, 6, 7, 8]]},
], ids=["history", "no-mask", "explicit-seen"])
def test_pad_requests_matches_jax(kwargs):
    hists = [[5, 6], [1, 2, 3, 4, 5, 6, 7], []]
    got = serve.pad_requests(hists, 4, 6, **kwargs)
    want = jax_serve.pad_requests(hists, 4, 6, **kwargs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    if not kwargs:
        np.testing.assert_array_equal(got[0][1], [4, 5, 6, 7])  # truncates left
        np.testing.assert_array_equal(got[1][1], [2, 3, 4, 5, 6, 7])  # most-recent kept
        assert got[2] == [1]


def _post(conn, body):
    conn.request("POST", "/rank", body if isinstance(body, str) else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


@pytest.fixture
def http_host(trained):
    server = serve.make_server(trained["port"], port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
    try:
        yield conn
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()


def test_serve_http_host_end_to_end(trained, http_host):
    """/healthz and /rank over HTTP; ranked ids equal the JAX host's
    `rank_request` on the JAX artifact, history never served, the seen cap
    reported, malformed bodies answered with 400 JSON."""
    conn, port = http_host, trained["port"]
    conn.request("GET", "/healthz")
    health = json.loads(conn.getresponse().read())
    assert health == {"ok": True, "max_len": MAX_LEN, "seen_width": trained["seen_width"]}
    conn.request("GET", "/nowhere")
    resp = conn.getresponse()
    assert resp.status == 404 and "error" in json.loads(resp.read())

    hists = [[3, 4, 5], list(range(1, 11)), [9]]
    status, got = _post(conn, {"input_ids": hists})
    assert status == 200
    want = jax_serve.rank_request(trained["jax"], {"input_ids": hists})
    ids, _, _ = serve.pad_requests(hists, MAX_LEN, trained["seen_width"])
    _assert_same_ids(got["topk"], want["topk"], _logits(trained, ids))
    for row, hist in zip(got["topk"], hists):
        assert not set(row) & (set(hist) | {0}), (row, hist)
    status, unmasked = _post(conn, {"input_ids": hists, "mask_history": False})
    assert status == 200 and unmasked["topk"] != got["topk"]

    long = list(range(1, 20))
    assert len(long) > trained["seen_width"]
    status, capped = _post(conn, {"input_ids": [long]})
    assert status == 200 and capped["seen_truncated"] == [0]

    for bad in ("{bad json",
                {"seen_items": [[1]]},  # no input_ids
                {"input_ids": hists, "seen_items": [[1]]},
                {"input_ids": hists, "user_ids": [1]}):
        status, err = _post(conn, bad)
        assert status == 400 and "error" in err, (bad, err)
    assert serve.rank_request(port, {"input_ids": []}) == {"topk": []}


def test_out_of_range_request_id_gives_400(trained, http_host):
    """Pinned divergence: an input id outside [0, item_size) is a 400 from
    the port's host (on the card the lookup would fire a device assert),
    where the JAX host answers 200 with a ranking from NaN scores."""
    for bad in ([[3, trained["item_size"]]], [[-1, 4]]):
        status, err = _post(http_host, {"input_ids": bad})
        assert status == 400 and "input_ids must lie in" in err["error"]
        assert "topk" in jax_serve.rank_request(trained["jax"], {"input_ids": bad})
    status, ok = _post(http_host, {"input_ids": [[3, trained["item_size"] - 1]]})
    assert status == 200 and len(ok["topk"][0]) == 20


def test_seen_masking_contract_eval_vs_serving():
    """The rank op's two modes against JAX's two contracts on all-negative
    scores: eval (seen -> 0.0, `ops/topk.py:masked_topk`) lets zeroed seen
    items lead the top-k; serving (seen -> -inf) never serves them or 0."""
    rng = np.random.default_rng(0)
    v, h, k = 12, 8, 4
    states = np.abs(rng.normal(size=(2, h))).astype(np.float32)
    table = -np.abs(rng.normal(size=(v, h))).astype(np.float32) - 0.1
    seen = np.asarray([[3, 5, 0], [7, 0, 0]], np.int32)
    logits = jnp.asarray(states) @ jnp.asarray(table).T
    s, t = torch.from_numpy(states), torch.from_numpy(table)

    eval_v, eval_i = rank.streaming_masked_topk(
        s, t, torch.from_numpy(rank.build_seen_bitmask(seen, v)), k=k)
    want_v, want_i = jax_eval_masked_topk(logits, jnp.asarray(seen), k=k)
    np.testing.assert_array_equal(eval_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(eval_v.numpy(), np.asarray(want_v), atol=SCORE_TOL, rtol=0)
    assert {3, 5} <= set(eval_i[0].tolist()) and 7 in eval_i[1].tolist()

    srv_v, srv_i = serving.bitmask_masked_topk(s, t, torch.from_numpy(seen), k)
    want_v, want_i = jax_serving.serving_masked_topk(logits, jnp.asarray(seen), k=k)
    np.testing.assert_array_equal(srv_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(srv_v.numpy(), np.asarray(want_v), atol=SCORE_TOL, rtol=0)
    assert not {0, 3, 5} & set(srv_i[0].tolist()) and not {0, 7} & set(srv_i[1].tolist())
    assert torch.isfinite(srv_v).all()


def _tie_inputs(b, v, h, seed):
    """Integer states and table (exact dot products, heavy ties at the
    top-k boundary) and seen lists with repeats, padding and ids outside
    [0, v)."""
    rng = np.random.default_rng(seed)
    states = rng.integers(-2, 3, size=(b, h)).astype(np.float32)
    table = rng.integers(-2, 3, size=(v, h)).astype(np.float32)
    seen = rng.integers(0, v, size=(b, 5)).astype(np.int32)
    seen = np.concatenate([seen, seen[:, :2], np.zeros((b, 2), np.int32)], axis=1)
    return states, table, seen


@pytest.mark.parametrize("v", [500, 24], ids=["catalog", "degenerate"])
def test_filtered_and_bitmask_equal_dense(v):
    """`filtered_masked_topk`, `bitmask_masked_topk` (the rank op) and
    `serving_masked_topk` return JAX's dense serving mask's ids and values
    exactly under heavy ties and repeated seen ids; at V=24 < k+S+1
    filtered falls back to dense and rows have fewer than k unmasked items."""
    states, table, seen = _tie_inputs(8, v, 16, seed=v)
    logits = states @ table.T
    want_v, want_i = jax_serving.serving_masked_topk(jnp.asarray(logits), jnp.asarray(seen), k=20)
    lt, st = torch.from_numpy(logits), torch.from_numpy(seen)
    for got_v, got_i in (serving.serving_masked_topk(lt, st, 20),
                         serving.filtered_masked_topk(lt, st, 20),
                         serving.bitmask_masked_topk(torch.from_numpy(states),
                                                     torch.from_numpy(table), st, 20)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_rank_op_drops_out_of_range_seen_ids():
    """Seen ids below 0 or at or past V are dropped (JAX's bitmask scatter
    drops them; a CUDA scatter out of bounds would assert), and the op's
    fake shape function gives its output shapes."""
    states, table, seen = _tie_inputs(4, 300, 16, seed=1)
    s, t = torch.from_numpy(states), torch.from_numpy(table)
    want = serving.bitmask_masked_topk(s, t, torch.from_numpy(seen), 20)
    wild = np.concatenate([seen, np.full((4, 1), -5, np.int32), np.full((4, 1), 300, np.int32),
                           np.full((4, 1), 1 << 30, np.int32)], axis=1)
    got = serving.bitmask_masked_topk(s, t, torch.from_numpy(wild), 20)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    bm = serving_topk.seen_bitmask(torch.from_numpy(wild), 300)
    np.testing.assert_array_equal(bm.numpy(), rank.build_seen_bitmask(seen, 300))
    torch.library.opcheck(torch.ops.bsarec_tpu_torch.serving_masked_topk.default,
                          (s, t, torch.from_numpy(wild), 20))


def test_chunked_matches_dense(trained, tmp_path):
    """`chunked_masked_topk` at chunks 7 (ragged tail), 8 and 64 (one
    block) ranks as dense, fp32 and int8, and equals JAX's scoring fn."""
    ids, uids, seen = _split(trained)
    args = (torch.from_numpy(ids), torch.from_numpy(uids), torch.from_numpy(seen))
    jargs = (jnp.asarray(ids), jnp.asarray(uids), jnp.asarray(seen))
    t = trained["t"]
    with torch.no_grad():
        for quant in (None, "int8"):
            dense = serving.build_scoring_fn(trained["model"], trained["item_size"], quant=quant,
                                             impl="dense")(*args)
            want = jax_serving.build_scoring_fn(t.model, trained["item_size"], quant=quant)(
                t.params, *jargs)
            _assert_same_ids(dense.numpy(), np.asarray(want), _logits(trained, ids))
            for chunk in (7, 8, 64):
                got = serving.build_scoring_fn(trained["model"], trained["item_size"], quant=quant,
                                               impl="chunked", item_chunk=chunk)(*args)
                assert torch.equal(got, dense), (quant, chunk)


def test_artifact_loads_with_the_op_module_alone(trained):
    """Another process loads the artifact with only the port's op module
    imported (no model code) and ranks as this one; without the op module
    the load fails on the unregistered custom op."""
    ids, uids, seen = (a[:5] for a in _split(trained))
    want = trained["port"].topk(ids, uids, seen)
    code = (
        "import sys, numpy as np, torch\n"
        "path, ids, uids, seen = sys.argv[1], *(np.load(p) for p in sys.argv[2:5])\n"
        "try:\n"
        "    torch.export.load(path)\n"
        "    sys.exit('loaded without the op module')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "import bsarec_tpu_torch.ops.serving_topk\n"
        "module = torch.export.load(path).module()\n"
        "with torch.inference_mode():\n"
        "    out = module(*(torch.from_numpy(a) for a in (ids, uids, seen)))\n"
        "assert not [m for m in sys.modules if m.startswith('bsarec_tpu_torch.models')]\n"
        "np.save(sys.argv[5], out.numpy())\n"
    )
    files = [str(trained["tmp"] / f"{n}.npy") for n in ("ids", "uids", "seen", "out")]
    for f, a in zip(files, (ids, uids, seen)):
        np.save(f, a)
    run = subprocess.run([sys.executable, "-c", code, trained["port_path"], *files], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=os.environ | {"PYTHONPATH": str(ROOT)})
    assert run.returncode == 0, run.stderr
    assert "custom op is not registered" in run.stderr
    np.testing.assert_array_equal(np.load(files[3]), want)


def test_main_export_serving_matches_jax_main(trained, tmp_path):
    """Both CLIs' `--do_eval --export_serving` on one corpus file and one
    checkpoint give artifacts that rank alike; the port's exports on
    `--device cpu` and logs its metadata."""
    from bsarec_tpu.main import main as jax_main
    from bsarec_tpu_torch.data.corpus import Corpus
    from bsarec_tpu_torch.data.pipeline import SeqRecData
    from bsarec_tpu_torch.main import main as port_main
    from bsarec_tpu_torch.train.checkpoint import save_params

    seqs = _corpus_seqs()
    seqs[-1].append(N_ITEMS)  # the file's largest id gives the CLIs item_size 31
    (tmp_path / "Toy.txt").write_text(
        "".join(f"{u + 1} {' '.join(map(str, s))}\n" for u, s in enumerate(seqs)))
    save_params(trained["model"].state_dict(), tmp_path / "init.ckpt")
    common = [
        "--data_dir", str(tmp_path), "--data_name", "Toy", "--output_dir", str(tmp_path),
        "--do_eval", "--model_type", "BSARec", "--max_seq_length", str(MAX_LEN),
        "--hidden_size", "16", "--num_hidden_layers", "1", "--num_attention_heads", "1",
        "--c", "3", "--alpha", "0.7",
    ]
    port_main(common + ["--device", "cpu", "--load_model", "init", "--train_name", "port",
                        "--export_serving", str(tmp_path / "port.pt2")])
    jax_main(common + ["--load_torch_model", str(tmp_path / "init.ckpt"), "--train_name", "jax",
                       "--export_serving", str(tmp_path / "jax.jaxexp")])
    assert "exported serving scorer" in (tmp_path / "port.log").read_text()
    # the CLIs export at their test split's seen width
    test = SeqRecData(Corpus(user_seq=seqs, max_item=N_ITEMS), MAX_LEN).test
    ids, uids, seen = test.input_ids, np.arange(test.num_users, dtype=np.int32), test.seen_items
    got = serving.load_scorer(str(tmp_path / "port.pt2"), "cpu").topk(ids, uids, seen)
    want = jax_serving.load_scorer(str(tmp_path / "jax.jaxexp")).topk(ids, uids, seen)
    _assert_same_ids(got, want, _logits(trained, ids))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serving.load_scorer(str(tmp_path / "port.pt2"))


def test_main_serving_impl_flag_takes_the_layouts():
    """`main --serving_impl` takes exactly `serving.IMPLS`, and parsing
    the CLI leaves the serving module (and its custom op) unimported."""
    code = (
        "import sys\n"
        "from bsarec_tpu_torch import main\n"
        "for impl in sys.argv[1:]:\n"
        "    assert main.parse_args(['--serving_impl', impl]).serving_impl == impl\n"
        "assert 'bsarec_tpu_torch.serving' not in sys.modules\n"
        "try:\n"
        "    main.parse_args(['--serving_impl', 'sparse'])\n"
        "    sys.exit('took an unknown layout')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 2\n"
    )
    run = subprocess.run([sys.executable, "-c", code, *serving.IMPLS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=os.environ | {"PYTHONPATH": str(ROOT)})
    assert run.returncode == 0, run.stderr
