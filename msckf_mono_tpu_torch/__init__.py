"""msckf_mono_tpu_torch: the MSCKF filter ported to PyTorch and CUDA.

A second package beside the JAX reference ``msckf_mono_tpu``. It mirrors that
package's layout and function names, imports neither ``jax`` nor anything of
``msckf_mono_tpu``, and carries an explicit leading filter-batch dimension B
on every tensor (B = 1 for one filter).

Entry points: ``core/filter`` (``step``, ``run_sequence``, ``finish``) and
``core/pipeline`` (image-in-the-loop fleets); ``interface.VioInterface``, the
live callback API at B = 1; ``cli/run_euroc`` (EuRoC/ASL and PennCOSYVIO
trees) and ``cli/run_synthetic``. Beneath them: the live front-end
(``frontend/track_handler``, ``ransac``, ``visualize``) and the dataset layer
(``data/asl``, ``sync``, ``penncosy``, ``native_loader``, ``png``,
``write_asl``, ``write_penncosy``), which needs neither PyYAML nor Pillow;
``utils/prng`` draws the fleet's and RANSAC's random numbers as the JAX
package does (threefry2x32 keys).
Every entry point runs on the card unless given ``device="cpu"`` (``--cpu``).
"""

import torch

# The filter math is full f32. TF32 on the card is the same trap as the bf16
# MXU passes recorded at msckf_mono_tpu/core/filter.py:70-75: a ~10-bit
# mantissa in the covariance products silently destroys the covariance
# algebra (the filter diverges within ~100 frames while staying finite).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
