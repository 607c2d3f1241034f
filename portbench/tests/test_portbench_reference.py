"""The frozen reference against the port on the CPU at a tiny size. The
test imports both; the reference modules import nothing of the port."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import aggregate
from portbench.reference.adam import Adam
from portbench.reference.pixelsnail import PixelSNAIL
from portbench.reference.vqvae2 import OBJECTIVES, VQVAE2, images_to_input
from portbench.reference.weights import make_weights

CPU = torch.device("cpu")


def tiny_vq():
    cfg = harness.config("vqvae2-celebahq256")
    cfg.update(image_size=32, train_images=64, hidden_dims=[16, 32],
               embedding_dim=8, num_embeddings=16, batch_size=8)
    return cfg


def tiny_snail(grid=6):
    cell = harness.workload("pixelsnail-k512-bf16.grid64")
    cell.update(grid=grid, batch_size=8, reference_chunk=4)
    cfg = harness.config("pixelsnail-k512-bf16")
    cfg.update(hidden_channels=16, num_heads=2, num_blocks=2,
               embedding_dim=8)
    return cell, cfg


def test_vqvae2_losses_match_the_port():
    from movae_tpu_torch.models import get_network

    cfg = tiny_vq()
    ref = VQVAE2(cfg)
    w = make_weights(ref, 3, CPU)
    ref.load_state_dict(w)
    port = get_network(32, 3, SimpleNamespace(
        arch="vq_vae2", embedding_dim=8, num_embeddings=16,
        hidden_dims=(16, 32), num_residual_layers=2,
        loss_weights=dict(cfg["loss_weights"]), recons_objective="mse",
        recons_activation="none", compute_dtype="float32"))
    port.load_state_dict(w)
    u8 = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8)
    x = images_to_input(u8)
    mine = ref.heads(*ref.trunk(x), x)
    from movae_tpu_torch.train.step import preprocess_batch
    _, theirs, _ = port.forward_with_losses(preprocess_batch(u8, True))
    for n in OBJECTIVES:
        assert float(mine[n]) == pytest.approx(float(theirs[n]), rel=1e-5)


def test_pixelsnail_logits_match_the_port_with_dropout():
    from movae_tpu_torch.train.prior import build_prior

    _, cfg = tiny_snail()
    ref = PixelSNAIL(cfg)
    w = make_weights(ref, 4, CPU)
    ref.load_state_dict(w)
    port = build_prior({"prior_type": "pixelsnail", "pixelsnail_num_blocks": 2,
                        "pixelcnn_hidden_channels": 16,
                        "pixelsnail_num_heads": 2, "pixelsnail_dropout": 0.1,
                        "attention_dropout": "output"}, 512, False, 8)
    port.load_state_dict(w)
    codes = torch.randint(0, 512, (3, 6, 6))
    got = port.logits_nchw(codes, train=True,
                           generator=torch.Generator().manual_seed(9))
    masks = ref.draw_masks(torch.Generator().manual_seed(9), 3, 36)
    want = ref.logits(codes, masks)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(ref.logits(codes), want)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adam_matches_the_port(clip):
    from movae_tpu_torch.train.optim import build_optimizer

    g = torch.Generator().manual_seed(0)
    a = [torch.randn(5, 3, generator=g), torch.randn(7, generator=g)]
    b = [t.clone().requires_grad_(True) for t in a]
    mine = Adam(a, lr=1e-2, max_grad_norm=clip)
    recipe = build_optimizer("adam", 1e-2, max_grad_norm=clip)
    opt = recipe.init(b)
    for i in range(3):
        grads = [torch.randn(t.shape, generator=g) for t in a]
        mine.step(grads)
        for p, gr in zip(b, grads):
            p.grad = gr.clone()
        recipe.step(opt, i)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y.detach(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", range(4))
def test_upgrad_weights_match_the_port(seed):
    from movae_tpu_torch.moo import AggregatorConfig
    from movae_tpu_torch.moo.aggregators import compute_weights

    rng = np.random.default_rng(seed)
    J = rng.standard_normal((3, 20))
    J[1] = -0.8 * J[0] + 0.1 * J[1]  # a conflicting pair
    G = J @ J.T
    alpha, _ = compute_weights(AggregatorConfig("upgrad", 3),
                               torch.tensor(G, dtype=torch.float32),
                               torch.zeros(3), {})
    np.testing.assert_allclose(aggregate.upgrad_weights(G),
                               alpha.double().numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("agg", ["upgrad", "sum"])
def test_stage1_run_reads_small_gaps_on_the_cpu(agg):
    cell = harness.workload(f"vqvae2-celebahq256.{agg}")
    res = harness.run_cell(cell["name"], 2 ** 31 + 7, 0.5, False, 0.0,
                           cell=cell, cfg=tiny_vq(), device="cpu")
    diag = res["diagnosis"]
    assert res["correct"], res["checks"]
    assert len(diag["loss_gap"]["losses"][0]) == 3


def test_prior_run_reads_small_gaps_on_the_cpu():
    cell, cfg = tiny_snail()
    res = harness.run_cell(cell["name"], 2 ** 31 + 11, 0.5, False, 0.0,
                           cell=cell, cfg=cfg, device="cpu")
    assert res["correct"], res["checks"]
    assert all(math.isfinite(c["value"]) for c in res["checks"].values())
