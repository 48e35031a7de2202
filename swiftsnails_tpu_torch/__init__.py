"""swiftsnails_tpu_torch — the PyTorch/CUDA port of swiftsnails, for one NVIDIA H100.

A second package beside the JAX one, with the same module paths and names, so
the counterpart of each JAX module is found at the same place:

* the packed ``[capacity, S, 128]`` parameter tables, the small-row plane
  and the 2-D ``[capacity, dim]`` plane, and their pull/push
  (:mod:`swiftsnails_tpu_torch.parallel.store`);
* the row gather and row scatter-add kernels, hand-written in CUDA C++ for
  ``sm_90a`` (``csrc/rowdma.cu``, bound in :mod:`swiftsnails_tpu_torch.ops.rowdma`);
* the word2vec SGNS trainer on its single-device paths
  (:mod:`swiftsnails_tpu_torch.models.word2vec`), the CTR families, the
  training loop (:mod:`swiftsnails_tpu_torch.framework.trainer`), the
  native batch producer (:mod:`swiftsnails_tpu_torch.data.native`, C++
  built with ``g++`` at first use), the quality probe
  (:mod:`swiftsnails_tpu_torch.framework.quality`), checkpoints, resilience
  and the loop's telemetry (:mod:`swiftsnails_tpu_torch.telemetry`);
* the serving read path: the servant, its fleet and router over a verified
  checkpoint (:mod:`swiftsnails_tpu_torch.serving`);
* the cluster plane: leased worker streams with exactly-once batch
  accounting, the simulated N-worker async-SGD fleet and its drills
  (:mod:`swiftsnails_tpu_torch.cluster`), and the chaos drill matrix
  (``python -m swiftsnails_tpu_torch.tools.chaos_drill``).

Entry points run on the card (``device=None`` means ``cuda``) and raise when
there is none, unless the caller passes ``device="cpu"``: then every kernel
wrapper runs its plain PyTorch version. The port imports neither JAX nor the
JAX package. ``ROADMAP.md`` lists what is not ported yet.
"""

__version__ = "0.1.0"

from swiftsnails_tpu_torch.utils.config import Config, load_config

__all__ = ["Config", "load_config", "__version__"]
