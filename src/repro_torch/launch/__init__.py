"""Launchers of the port: `python -m repro_torch.launch.serve` (``--dvs``,
``--fleet``, ``--arch``), `python -m repro_torch.launch.train` (QAT),
`python -m repro_torch.launch.train_lm` (the LM scaffold) and `python -m
repro_torch.launch.dryrun` (every LM cell on meta tensors, under the
sharding plan of `launch/sharding.py` over the meshes of `launch/mesh.py`)."""
