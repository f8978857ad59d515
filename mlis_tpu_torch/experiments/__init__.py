"""The decision-quality experiments of ``experiments/*.py`` on the port.

Each module is the counterpart of the script of the same name: the same
arguments, defaults, printed lines and JSON keys, run through the port's
``eval/quality``, ``weights`` and ``train/pretrain_vpr`` on ``--device``
(default ``cuda``). ``--out`` defaults to the script's file name under
``results/torch/``, so that a run never overwrites a committed
``results/*.json``. Run one as ``python -m mlis_tpu_torch.experiments.<name>``.
"""
