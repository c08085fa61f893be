"""Port BSARec vs the JAX BSARec on the same weights, carried both ways:
JAX init -> `params_from_jax` -> port, and port init -> JAX's own
`import_bsarec` -> JAX. Eval mode (dropout off), fp32, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu.config import ModelConfig as JaxModelConfig
from bsarec_tpu.models import build_model as jax_build_model
from bsarec_tpu.train.torch_import import import_bsarec
from bsarec_tpu_torch.config import ModelConfig
from bsarec_tpu_torch.models import build_model
from bsarec_tpu_torch.train.checkpoint import load_params, save_params
from bsarec_tpu_torch.train.jax_import import params_from_jax

ATOL = 1e-5
FIELDS = dict(model_type="bsarec", item_size=40, num_users=20, max_seq_length=12,
              hidden_size=32, num_hidden_layers=2, num_attention_heads=2, c=5, alpha=0.7)


def _input_ids(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, FIELDS["item_size"], size=(7, FIELDS["max_seq_length"])).astype(np.int32)
    for r in range(ids.shape[0]):
        ids[r, : r + 1] = 0  # left padding of growing length
    return ids


def _jax_model_and_params(seed=0):
    model = jax_build_model(JaxModelConfig(**FIELDS))
    key = jax.random.PRNGKey(seed)
    dummy = jnp.zeros((2, FIELDS["max_seq_length"]), jnp.int32)
    params = model.init({"params": key, "dropout": key}, dummy, train=False)["params"]
    # nonzero LayerNorm affine terms and biases, so the carried layout is checked too
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32),
                          jax.device_get(params))
    return model, params


def _port_forward(model, ids, all_layers=False):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(ids), all_layers=all_layers)


def test_forward_matches_jax_from_jax_weights():
    jmodel, params = _jax_model_and_params()
    model = build_model(ModelConfig(**FIELDS))
    model.load_state_dict(params_from_jax(params))  # strict: every key carried
    ids = _input_ids()
    want = jmodel.apply({"params": params}, jnp.asarray(ids), train=False, all_layers=True)
    got = _port_forward(model, ids, all_layers=True)
    assert len(got) == len(want) == FIELDS["num_hidden_layers"] + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    np.testing.assert_allclose(model.predict(torch.from_numpy(ids)).detach().numpy(),
                               np.asarray(want[-1]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("length", [FIELDS["max_seq_length"], 8])
def test_forward_matches_jax_from_port_weights(length):
    model = build_model(ModelConfig(**FIELDS), generator=torch.Generator().manual_seed(3))
    jmodel = jax_build_model(JaxModelConfig(**FIELDS))
    params = import_bsarec(model.state_dict(), num_layers=FIELDS["num_hidden_layers"])
    ids = _input_ids(1)[:, -length:]
    want = jmodel.apply({"params": params}, jnp.asarray(ids), train=False)
    np.testing.assert_allclose(_port_forward(model, ids).numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_init_statistics_and_padding_row():
    model = build_model(ModelConfig(**FIELDS), generator=torch.Generator().manual_seed(0))
    table = model.item_table.detach()
    assert table.shape == (FIELDS["item_size"], FIELDS["hidden_size"])
    assert torch.count_nonzero(table[0]) == 0
    assert abs(float(table[1:].std()) - 0.02) < 0.003
    sd = model.state_dict()
    assert "item_encoder.blocks.1.layer.filter_layer.sqrt_beta" in sd
    assert sd["item_encoder.blocks.0.layer.filter_layer.sqrt_beta"].shape == (1, 1, FIELDS["hidden_size"])
    assert "LayerNorm.weight" in sd  # the embedding LayerNorm, reference key
    again = build_model(ModelConfig(**FIELDS), generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())


def test_checkpoint_round_trip(tmp_path):
    model = build_model(ModelConfig(**FIELDS), generator=torch.Generator().manual_seed(4))
    path = tmp_path / "sub" / "m.ckpt"
    save_params(model.state_dict(), path)
    assert not path.with_suffix(".ckpt.tmp").exists()
    loaded = load_params(path)
    assert loaded.keys() == model.state_dict().keys()
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in loaded.items())


@pytest.mark.parametrize("fields", [{"compute_dtype": "float16"}])
def test_unported_configurations_raise(fields):
    with pytest.raises(NotImplementedError, match="is not ported"):
        build_model(ModelConfig(**(FIELDS | fields)))


def test_bf16_model_builds_with_fp32_parameters():
    """The bf16 policy changes the compute, not the parameters: the same
    seed builds the same float32 weights, and the gradients are float32."""
    fp32 = build_model(ModelConfig(**FIELDS), generator=torch.Generator().manual_seed(0))
    bf16 = build_model(ModelConfig(**(FIELDS | {"compute_dtype": "bfloat16"})),
                       generator=torch.Generator().manual_seed(0))
    assert bf16.state_dict().keys() == fp32.state_dict().keys()
    for k, v in bf16.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, fp32.state_dict()[k]), k
    ids = torch.randint(1, FIELDS["item_size"], (3, FIELDS["max_seq_length"]),
                        generator=torch.Generator().manual_seed(1))
    bf16.calculate_loss(ids, ids[:, -1]).backward()
    assert all(p.grad.dtype == torch.float32 for p in bf16.parameters() if p.grad is not None)


def test_unknown_model_type_raises():
    with pytest.raises(ValueError, match="unknown model type 'bert5rec'"):
        build_model(ModelConfig(**(FIELDS | {"model_type": "bert5rec"})))
