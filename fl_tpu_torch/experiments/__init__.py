"""The headline experiments on the port, one module for each of the
reference's experiment scripts (``scripts/*.py``): each keeps its
script's flags and defaults (or module constants), printed lines, exit
code and the key tree of its JSON record, and adds ``--device`` (the
card by default) and ``--out``. Records go to ``docs/torch/`` under the
reference's file names. Run: ``python -m fl_tpu_torch.experiments.<name>
[flags]``; each module's ``main(argv=None)`` does the same in process."""
