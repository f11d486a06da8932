"""Launchers of the port: `python -m repro_torch.launch.serve` (``--dvs``,
``--fleet``, ``--arch``), `python -m repro_torch.launch.train` (QAT) and
`python -m repro_torch.launch.train_lm` (the LM scaffold)."""
