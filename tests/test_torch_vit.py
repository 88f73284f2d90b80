"""The port's ViTs against the JAX package, on the CPU.

- **trees**: ``vit_b16``, ``vit_l16`` and ``vit_tiny`` at full width:
  every leaf of the Flax tree converts to the port's ``state_dict``
  (names, shapes and parameter counts equal), with no weights made.
- **forward**: ``vit_tiny`` (4 layers, hidden 64, 4 heads of 16, patch
  8 at 32 px: 17 tokens), float32, ``dense`` and ``flash`` (the flash
  kernels' plain version here, Pallas in interpret mode on the JAX
  side), in eval mode: logits within 1e-4 of their largest magnitude.
- **two steps**: the same model, both attention arms, dropout off on
  both sides: the losses (1e-4 relative) and every parameter after two
  momentum-SGD steps (1e-4 of the largest).
- **remat**: ``--gradient_checkpointing`` with dropout on gives the
  plain step's loss, every gradient and the dropout generator's state
  after the backward, bit for bit.
- **registry, flags, checkpoints**: the ViTs take ``--attention_impl``
  and ``--gradient_checkpointing`` and their dropout generator;
  ``--scan_layers`` is refused, as in JAX; a ``vit_tiny`` and a
  ``resnet20_cifar`` state save, restore and fingerprint; the launcher
  trains ``vit_tiny`` on the CPU.
"""

from __future__ import annotations

import json
import math

import pytest
import torch

from tpu_hc_bench.models import vit as jax_vit
from tpu_hc_bench_torch import flags, launcher
from tpu_hc_bench_torch.data.synthetic import SyntheticImages, to_device
from tpu_hc_bench_torch.models import (DROPOUT_SEED_OFFSET, create_model,
                                       get_model_spec, vit)
from tpu_hc_bench_torch.train import step as step_mod
from tpu_hc_bench_torch.utils import checkpoint as ckpt

from torch_zoo_common import check_forward, check_tree, images, two_steps


@pytest.mark.parametrize("name", ["vit_b16", "vit_l16", "vit_tiny"])
def test_full_width_tree_converts(name):
    check_tree(name)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_vit_tiny_forward_matches_jax(impl):
    check_forward(jax_vit.vit_tiny(attention_impl=impl),
                  vit.vit_tiny(attention_impl=impl), "vit",
                  images((2, 32, 32, 3), 1), train=False)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_vit_tiny_two_train_steps_match_jax(impl):
    imgs, labels = SyntheticImages(4, (32, 32, 3), 1000, seed=3).batch()
    two_steps(jax_vit.vit_tiny(attention_impl=impl),
              vit.vit_tiny(attention_impl=impl), "vit", (imgs, labels),
              lr=0.01, dropout=True)


def _seeded(remat: bool) -> vit.ViT:
    m = vit.vit_tiny(remat=remat)
    m.init_weights(torch.Generator().manual_seed(3))
    m.dropout_generator = torch.Generator().manual_seed(4)
    return m.train()


def test_remat_is_bit_equal_to_the_plain_step_with_dropout_on():
    plain, rematted = _seeded(False), _seeded(True)
    batch = to_device(SyntheticImages(2, (32, 32, 3), 1000, seed=5).batch(),
                      torch.device("cpu"))
    losses = []
    for m in (plain, rematted):
        loss = step_mod.batch_loss(m, batch)
        loss.backward()
        losses.append(loss.detach())
    assert torch.equal(losses[0], losses[1])
    for (k, p), q in zip(plain.named_parameters(), rematted.parameters()):
        assert torch.equal(p.grad, q.grad), k
    assert torch.equal(plain.dropout_generator.get_state(),
                       rematted.dropout_generator.get_state())
    # dropout was drawn: the same weights in eval mode give another loss
    with torch.no_grad():
        assert not torch.equal(step_mod.batch_loss(plain.eval(), batch),
                               losses[0])


def test_registry_flags_and_guards():
    spec = get_model_spec("vit_b16")
    assert (spec.attention, spec.input_shape, spec.flops_per_example) == (
        True, (224, 224, 3), 35.2e9)
    assert get_model_spec("vit_tiny").input_shape == (32, 32, 3)
    model, _ = create_model("vit_tiny", torch.bfloat16, "flash",
                            device="cpu", seed=2, train=True,
                            gradient_checkpointing=True, rank=1)
    assert model.remat and model.training and model.dtype == torch.bfloat16
    assert model.layers[0].attn.attention_impl == "flash"
    assert model.pos_embed.shape == (1, 17, 64)
    assert model.dropout_generator.initial_seed() != 2 + DROPOUT_SEED_OFFSET
    assert create_model("vit_tiny", device="cpu", seed=2)[
        0].dropout_generator.initial_seed() == 2 + DROPOUT_SEED_OFFSET
    assert not model.cls.detach().any()
    with pytest.raises(ValueError, match="decoder families"):
        create_model("vit_tiny", device="cpu", scan_layers=True)
    with pytest.raises(ValueError, match="s2d"):
        create_model("vit_tiny", device="cpu", space_to_depth=True)
    cfg = flags.parse_benchmark_flags(["--model=vit_b16",
                                       "--attention_impl=flash",
                                       "--gradient_checkpointing=true"])
    assert (cfg.attention_impl, cfg.gradient_checkpointing) == ("flash",
                                                                True)


@pytest.mark.parametrize("name", ["vit_tiny", "resnet20_cifar"])
def test_checkpoint_round_trip(name, tmp_path):
    cfg = flags.BenchmarkConfig(device="cpu", model=name).resolve()
    model, spec = create_model(name, device="cpu", seed=1, train=True)
    state = step_mod.make_train_state(model, cfg)
    batch = to_device(SyntheticImages(2, spec.input_shape, 1000,
                                      seed=2).batch(), torch.device("cpu"))
    step_mod.train_step(state, batch)
    live = ckpt.topology_record(1, cfg)
    ckpt.save(state, tmp_path, topology=live)
    again = step_mod.make_train_state(
        create_model(name, device="cpu", seed=9, train=True)[0], cfg)
    ckpt.restore(again, tmp_path, expect_topology=live)
    assert ckpt.fingerprint(again.model.state_dict()) == \
        ckpt.fingerprint(state.model.state_dict())
    assert again.step == state.step == 1
    gens = [getattr(m, "dropout_generator", None)
            for m in (state.model, again.model)]
    if name.startswith("vit"):
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
    else:
        assert gens == [None, None]
    # both go on to the same next step
    _, a = step_mod.train_step(state, batch)
    _, b = step_mod.train_step(again, batch)
    assert torch.equal(a["loss"], b["loss"])


def test_launcher_trains_vit_tiny_on_the_cpu():
    lines: list[str] = []
    rc = launcher.main(["1", "1", "2", "sock", "--model=vit_tiny",
                        "--device=cpu", "--attention_impl=flash",
                        "--gradient_checkpointing=true",
                        "--num_warmup_batches=1", "--num_batches=2"],
                       print_fn=lines.append)
    assert rc == 0
    assert any("total images/sec" in ln for ln in lines)
    res = json.loads(lines[-1])
    assert res["model"] == "vit_tiny" and math.isfinite(res["final_loss"])
