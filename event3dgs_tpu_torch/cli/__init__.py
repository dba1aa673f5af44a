"""Command-line entry points:

- ``python -m event3dgs_tpu_torch.cli.train``      ← reference `train.py`
- ``python -m event3dgs_tpu_torch.cli.render``     ← reference `render.py`
- ``python -m event3dgs_tpu_torch.cli.evaluate``   ← reference `eval.py`
- ``python -m event3dgs_tpu_torch.cli.metrics``    ← reference `metrics.py`
- ``python -m event3dgs_tpu_torch.cli.full_eval``  ← reference `full_eval.py`
"""
