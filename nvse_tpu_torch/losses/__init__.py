from .gan import (
    feature_loss,
    hinge_discriminator_loss,
    hinge_generator_loss,
    ls_discriminator_loss,
    ls_generator_loss,
)
from .spectral import amplitude_loss, anti_wrapping_function, phase_loss, stft_consistency_loss
