"""PyTorch/CUDA port of ``event3dgs_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its subpackage
and module names (``core/``, ``data/``, ``losses/``, ``models/``,
``ops/``, ``tools/``, ``cli/``, ``utils/``, ``train/``) so each module's
counterpart is easy to find.  It imports ``torch``, numpy, scipy and PIL
only — never JAX or the JAX package.

The render path (``python -m event3dgs_tpu_torch.cli.render``) and the
training path (``python -m event3dgs_tpu_torch.cli.train``) run the tile
binning, compositing and gradient-reduction kernels written by hand in
CUDA C++ (``csrc/``).  They are compiled with ``nvcc`` for ``sm_90a`` on
first use and bound with ``ctypes`` (``ops/kernels.py``); importing the
package never needs ``nvcc``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.
"""
