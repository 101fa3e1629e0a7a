"""PyTorch port, models/hf_import.py, against the JAX package.

- For each of the five families (BERT, GPT-2, ViT, Llama, T5 v1.0 and
  v1.1): an HF-layout state dict built here (HF's key names, shapes from
  the tiny configs, values from a seed). The port's mapping, from numpy
  arrays and from torch tensors, equals the JAX mapping
  (``convert.params_from_jax`` of it) bitwise, key for key, in f32; the
  result loads into the port's model with ``strict=True``; Llama without
  ``lm_head.weight`` takes the tied fallback in both.
- ``load_safetensors``, the port's own reader, against
  ``safetensors.numpy.load_file`` for F32, F16, I64 and I8 and against
  ``safetensors.torch.load_file`` for BF16 (kept as ``torch.bfloat16``),
  on files ``safetensors`` writes here; a BF16 Llama checkpoint read by
  the port and mapped equals the f32 mapping of the same values.
- The reader refuses a truncated header, a header past the file's end,
  malformed JSON or entries, out-of-bounds or mis-sized offsets and an
  unknown dtype.
"""

import json
import struct

import numpy as np
import pytest
import torch

from tensorlink_tpu_torch.convert import params_from_jax
from tensorlink_tpu_torch.models import hf_import

V, D, L, F = 128, 32, 2, 64


def _filler(seed):
    r = np.random.default_rng(seed)

    def put(sd, name, *shape):
        sd[name] = r.standard_normal(shape).astype(np.float32)

    return put


def _bert_sd(seed=0):
    put, sd = _filler(seed), {}
    put(sd, "embeddings.word_embeddings.weight", V, D)
    put(sd, "embeddings.position_embeddings.weight", 64, D)
    put(sd, "embeddings.token_type_embeddings.weight", 2, D)
    for n in ("weight", "bias"):
        put(sd, f"embeddings.LayerNorm.{n}", D)
    put(sd, "pooler.dense.weight", D, D)
    put(sd, "pooler.dense.bias", D)
    for i in range(L):
        pre = f"encoder.layer.{i}."
        for part in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            put(sd, pre + part + ".weight", D, D)
            put(sd, pre + part + ".bias", D)
        put(sd, pre + "intermediate.dense.weight", F, D)
        put(sd, pre + "intermediate.dense.bias", F)
        put(sd, pre + "output.dense.weight", D, F)
        put(sd, pre + "output.dense.bias", D)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            put(sd, pre + ln + ".weight", D)
            put(sd, pre + ln + ".bias", D)
    return sd


def _gpt2_sd(seed=1):
    put, sd = _filler(seed), {}
    put(sd, "wte.weight", V, D)
    put(sd, "wpe.weight", 64, D)
    put(sd, "ln_f.weight", D)
    put(sd, "ln_f.bias", D)
    for i in range(L):
        pre = f"h.{i}."
        for ln in ("ln_1", "ln_2"):
            put(sd, pre + ln + ".weight", D)
            put(sd, pre + ln + ".bias", D)
        put(sd, pre + "attn.c_attn.weight", D, 3 * D)  # Conv1D: [in, out]
        put(sd, pre + "attn.c_attn.bias", 3 * D)
        put(sd, pre + "attn.c_proj.weight", D, D)
        put(sd, pre + "attn.c_proj.bias", D)
        put(sd, pre + "mlp.c_fc.weight", D, 4 * D)
        put(sd, pre + "mlp.c_fc.bias", 4 * D)
        put(sd, pre + "mlp.c_proj.weight", 4 * D, D)
        put(sd, pre + "mlp.c_proj.bias", D)
    return sd


def _vit_sd(seed=2):
    put, sd = _filler(seed), {}
    P, N = 8, 16  # ViTConfig.tiny(): 32 x 32 images, patches of 8
    put(sd, "embeddings.patch_embeddings.projection.weight", D, 3, P, P)
    put(sd, "embeddings.patch_embeddings.projection.bias", D)
    put(sd, "embeddings.cls_token", 1, 1, D)
    put(sd, "embeddings.position_embeddings", 1, N + 1, D)
    put(sd, "layernorm.weight", D)
    put(sd, "layernorm.bias", D)
    for i in range(L):
        pre = f"encoder.layer.{i}."
        for ln in ("layernorm_before", "layernorm_after"):
            put(sd, pre + ln + ".weight", D)
            put(sd, pre + ln + ".bias", D)
        for part in ("attention.attention.query", "attention.attention.key",
                     "attention.attention.value", "attention.output.dense"):
            put(sd, pre + part + ".weight", D, D)
            put(sd, pre + part + ".bias", D)
        put(sd, pre + "intermediate.dense.weight", F, D)
        put(sd, pre + "intermediate.dense.bias", F)
        put(sd, pre + "output.dense.weight", D, F)
        put(sd, pre + "output.dense.bias", D)
    return sd


def _llama_sd(seed=3, tied=False):
    put, sd = _filler(seed), {}
    hd, H, Hkv = 8, 4, 2  # LlamaConfig.tiny()
    put(sd, "model.embed_tokens.weight", V, D)
    put(sd, "model.norm.weight", D)
    if not tied:
        put(sd, "lm_head.weight", V, D)
    for i in range(L):
        pre = f"model.layers.{i}."
        put(sd, pre + "input_layernorm.weight", D)
        put(sd, pre + "post_attention_layernorm.weight", D)
        put(sd, pre + "self_attn.q_proj.weight", H * hd, D)
        put(sd, pre + "self_attn.k_proj.weight", Hkv * hd, D)
        put(sd, pre + "self_attn.v_proj.weight", Hkv * hd, D)
        put(sd, pre + "self_attn.o_proj.weight", D, H * hd)
        for m in ("up_proj", "gate_proj"):
            put(sd, pre + f"mlp.{m}.weight", F, D)
        put(sd, pre + "mlp.down_proj.weight", D, F)
    return sd


def _t5_sd(gated: bool, seed=4):
    put, sd = _filler(seed), {}
    H, hd, nb = 2, 16, 8  # T5Config.tiny()
    put(sd, "shared.weight", V, D)
    for side in ("encoder", "decoder"):
        put(sd, f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
            nb, H)
        put(sd, f"{side}.final_layer_norm.weight", D)
        for i in range(L):
            pre = f"{side}.block.{i}.layer."
            attns = [("0", "SelfAttention")] + (
                [("1", "EncDecAttention")] if side == "decoder" else [])
            for n, kind in attns:
                put(sd, pre + f"{n}.layer_norm.weight", D)
                for p in "qkv":
                    put(sd, pre + f"{n}.{kind}.{p}.weight", H * hd, D)
                put(sd, pre + f"{n}.{kind}.o.weight", D, H * hd)
            ff = "2" if side == "decoder" else "1"
            put(sd, pre + f"{ff}.layer_norm.weight", D)
            ffp = pre + f"{ff}.DenseReluDense."
            for wi in (("wi_0", "wi_1") if gated else ("wi",)):
                put(sd, ffp + wi + ".weight", F, D)
            put(sd, ffp + "wo.weight", D, F)
    if gated:
        put(sd, "lm_head.weight", V, D)
    return sd


def _families():
    from tensorlink_tpu_torch.models import (
        Bert,
        BertConfig,
        GPT2,
        GPT2Config,
        Llama,
        LlamaConfig,
        T5,
        T5Config,
        ViT,
        ViTConfig,
    )

    t5_11 = T5Config(**{**T5Config.tiny().__dict__, "gated_ff": True,
                        "tie_word_embeddings": False})
    bert = BertConfig.tiny()
    return {
        "bert": ("bert_params_from_hf", _bert_sd, bert, Bert),
        "gpt2": ("gpt2_params_from_hf", _gpt2_sd, GPT2Config.tiny(), GPT2),
        "vit": ("vit_params_from_hf", _vit_sd, ViTConfig.tiny(), ViT),
        "llama": ("llama_params_from_hf", _llama_sd, LlamaConfig.tiny(), Llama),
        "llama_tied": ("llama_params_from_hf", lambda: _llama_sd(tied=True),
                       LlamaConfig.tiny(), Llama),
        "t5_v1.0": ("t5_params_from_hf", lambda: _t5_sd(False), T5Config.tiny(), T5),
        "t5_v1.1": ("t5_params_from_hf", lambda: _t5_sd(True), t5_11, T5),
    }


def _jax_cfg(cfg):
    """The JAX package's config class of the same name and fields."""
    import importlib

    mod = {"BertConfig": "bert", "GPT2Config": "gpt2", "ViTConfig": "vit",
           "LlamaConfig": "llama", "T5Config": "t5"}[type(cfg).__name__]
    cls = getattr(importlib.import_module(f"tensorlink_tpu.models.{mod}"),
                  type(cfg).__name__)
    return cls(**cfg.__dict__)


@pytest.mark.parametrize("family", sorted(_families()))
def test_mapping_equals_the_jax_mapping_bitwise(family):
    import jax

    from tensorlink_tpu.models import hf_import as j_hf

    fn, build, cfg, model_cls = _families()[family]
    sd = build()
    ref = params_from_jax(jax.device_get(getattr(j_hf, fn)(sd, _jax_cfg(cfg))))
    for form in ("numpy", "torch"):
        src = sd if form == "numpy" else {k: torch.from_numpy(v) for k, v in sd.items()}
        ours = getattr(hf_import, fn)(src, cfg)
        assert sorted(ours) == sorted(ref), (family, form)
        for k, v in ref.items():
            assert ours[k].dtype == torch.float32 and ours[k].shape == v.shape, k
            assert torch.equal(ours[k], v), (family, form, k)
    model = model_cls(cfg, device="cpu", seed=None)
    model.load_state_dict(ours, strict=True)
    if family == "llama_tied":
        assert torch.equal(ours["lm_head.w"], ours["tok_emb.table"].T)


def test_strip_prefix():
    sd = {"bert.embeddings.x": 1, "cls.y": 2}
    assert hf_import.strip_prefix(sd, "bert.") == {"embeddings.x": 1, "cls.y": 2}


# ---------------------------------------------------------------- reader


@pytest.mark.parametrize("dtype", ["F32", "F16", "I64", "I8", "BF16"])
def test_reader_equals_safetensors(dtype, tmp_path):
    st = pytest.importorskip("safetensors")
    del st
    from safetensors.torch import load_file as t_load
    from safetensors.torch import save_file as t_save

    g = torch.Generator().manual_seed(0)
    base = {"a": torch.randn((3, 5), generator=g), "b.c": torch.randn((7,), generator=g),
            "scalar": torch.randn((), generator=g), "empty": torch.zeros((0, 4))}
    tdt = {"F32": torch.float32, "F16": torch.float16, "I64": torch.int64,
           "I8": torch.int8, "BF16": torch.bfloat16}[dtype]
    tensors = {k: (v * 50).to(tdt) for k, v in base.items()}
    path = str(tmp_path / "x.safetensors")
    t_save(tensors, path, metadata={"format": "pt"})
    ours = hf_import.load_safetensors(path)
    assert sorted(ours) == sorted(tensors)
    if dtype == "BF16":
        ref = t_load(path)
        for k, v in ref.items():
            assert ours[k].dtype == torch.bfloat16 and torch.equal(ours[k], v), k
        return
    from safetensors.numpy import load_file as np_load

    ref = np_load(path)
    for k, v in ref.items():
        got = ours[k].numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)


def test_bf16_checkpoint_maps_like_its_f32_values(tmp_path):
    """A Llama checkpoint stored in BF16 (as Meta ships Llama-3): the port
    reads it as bfloat16 and its mapping equals the f32 mapping of the
    same (bf16-representable) values."""
    pytest.importorskip("safetensors")
    from safetensors.torch import save_file

    from tensorlink_tpu_torch.models.llama import LlamaConfig

    sd = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _llama_sd().items()}
    path = str(tmp_path / "llama.safetensors")
    save_file(sd, path)
    read = hf_import.load_safetensors(path)
    assert all(v.dtype == torch.bfloat16 for v in read.values())
    ours = hf_import.llama_params_from_hf(read, LlamaConfig.tiny())
    ref = hf_import.llama_params_from_hf({k: v.float() for k, v in sd.items()},
                                         LlamaConfig.tiny())
    assert all(torch.equal(ours[k], ref[k]) for k in ref)


def _raw(path, header: dict, data: bytes, n=None):
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h) if n is None else n) + h + data)


@pytest.mark.parametrize("fault", ["short", "past_end", "out_of_bounds",
                                   "mis_sized", "dtype", "not_json", "entry"])
def test_reader_refuses_bad_files(fault, tmp_path):
    path = str(tmp_path / "bad.safetensors")
    good = {"x": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}
    data = b"\0" * 8
    if fault == "short":
        with open(path, "wb") as f:
            f.write(b"\x10\0\0")
        match = "too short"
    elif fault == "past_end":
        _raw(path, good, data, n=1 << 20)
        match = "past the file's end"
    elif fault == "out_of_bounds":
        _raw(path, {"x": dict(good["x"], data_offsets=[8, 16], shape=[2])}, data)
        match = "out of bounds"
    elif fault == "mis_sized":
        _raw(path, {"x": dict(good["x"], shape=[3])}, data)
        match = "out of bounds"
    elif fault == "dtype":
        _raw(path, {"x": dict(good["x"], dtype="F8_E9")}, data)
        match = "unknown dtype"
    elif fault == "entry":
        _raw(path, {"x": {"dtype": "F32", "shape": [2]}}, data)
        match = "malformed entry"
    else:
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", 4) + b"{no}" + data)
        match = "malformed"
    with pytest.raises(ValueError, match=match):
        hf_import.load_safetensors(path)
    # and the well-formed file reads
    _raw(path, good, data)
    assert torch.equal(hf_import.load_safetensors(path)["x"], torch.zeros(2))
