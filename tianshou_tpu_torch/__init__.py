"""tianshou_tpu_torch: the PyTorch + CUDA port of ``tianshou_tpu``.

Module names mirror the JAX package (``envs/base.py`` here is the port of
``tianshou_tpu/envs/base.py``, and so on).  The port imports ``torch`` and
nothing of JAX or of ``tianshou_tpu``.  Its entry points run on
``device="cuda"`` unless the caller asks for ``"cpu"``; there is no silent
fallback.  The replay presample's uint8 -> bf16 row gather runs through a
hand-written CUDA kernel (``csrc/gather_rows_cast.cu``), built with ``nvcc``
at first use (``ops/_build.py``).
"""

__version__ = "0.1.0"

from tianshou_tpu_torch.data.batch import Batch  # noqa: E402

__all__ = ["Batch", "__version__"]
