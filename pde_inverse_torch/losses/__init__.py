"""Consistency losses (counterpart of pde_inverse_tpu.losses)."""

from pde_inverse_torch.losses import kinetic_fokker_planck, kinetic_mckean_vlasov

LOSS_MODULES = {
    "Kinetic-Fokker-Planck": kinetic_fokker_planck,
    "Kinetic-McKean-Vlasov": kinetic_mckean_vlasov,
}

__all__ = ["LOSS_MODULES"]
