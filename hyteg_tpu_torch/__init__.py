"""hyteg_tpu_torch: the PyTorch + CUDA port of hyteg_tpu (matrix-free P1
finite elements + geometric multigrid on macro-tet meshes).

Package-wide numerical policy: every f32 stays f32.  TF32 matmuls and
convolutions are switched off because solver dot products must not be
rounded: in the JAX package, CG step sizes computed from bf16-rounded dot
products turned the box-GMG coarse solve into an error *amplifier*
(residual x2.11/cycle at level 6) while the identical float32 program
converged (see hyteg_tpu/__init__.py).  TF32 keeps about three decimal
digits, which is the same hazard.  The hot stencil paths are hand-written
CUDA kernels and do not pay for this.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
