"""The port's example scripts: the counterparts of the JAX package's
``examples/*.py``, which are its command line.  Each module has the JAX
script's flags (``--device`` in place of ``--platform``, default
``"cuda"``), ``parser()``, ``build(args, logger=None)`` and ``main(argv=None,
logger=None)``; run one as ``python -m tianshou_tpu_torch.examples.<name>``.
Importing a module parses nothing and imports no env package: gymnasium,
tensorboard and h5py are imported inside ``build``.
"""

from __future__ import annotations

import time


def run(trainer, venvs=()) -> tuple:
    """``(trainer.run()'s info, its wall seconds)``, closing ``venvs`` after
    the run, whether it ends or raises."""
    t0 = time.time()
    try:
        info = trainer.run()
    finally:
        for venv in venvs:
            venv.close()
    return info, time.time() - t0
