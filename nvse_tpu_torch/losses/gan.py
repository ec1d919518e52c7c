"""GAN adversarial and feature-matching losses.

Counterpart of nvse_tpu/losses/gan.py (reference Models/models.py:607-661):
least-squares losses for the T-F trainer, hinge losses for the time
trainer's MSD generators.
"""
from __future__ import annotations

import torch


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """Sum over sub-discriminators and layers of mean |real - generated|."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss


def ls_discriminator_loss(real_outputs, generated_outputs):
    """E[(1 - D(y))^2] + E[D(G)^2] per sub-discriminator, summed."""
    loss, r_losses, g_losses = 0.0, [], []
    for dr, dg in zip(real_outputs, generated_outputs):
        r_loss = torch.mean((1.0 - dr) ** 2)
        g_loss = torch.mean(dg ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def ls_generator_loss(disc_outputs):
    """E[(1 - D(G))^2] per sub-discriminator, summed."""
    gen_losses = [torch.mean((1.0 - dg) ** 2) for dg in disc_outputs]
    return sum(gen_losses), gen_losses


def hinge_discriminator_loss(real_outputs, generated_outputs):
    """E[max(1 - D(y), 0)] + E[max(1 + D(G), 0)] per sub-discriminator, summed."""
    loss, r_losses, g_losses = 0.0, [], []
    for dr, dg in zip(real_outputs, generated_outputs):
        r_loss = torch.mean(torch.clamp(1.0 - dr, min=0.0))
        g_loss = torch.mean(torch.clamp(1.0 + dg, min=0.0))
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def hinge_generator_loss(disc_outputs):
    """E[max(1 - D(G), 0)] per sub-discriminator, summed."""
    gen_losses = [torch.mean(torch.clamp(1.0 - dg, min=0.0)) for dg in disc_outputs]
    return sum(gen_losses), gen_losses
