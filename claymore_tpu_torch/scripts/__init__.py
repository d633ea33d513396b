"""The port's profiling entry points, each run as ``python -m
claymore_tpu_torch.scripts.<name>`` with ``--device`` defaulting to ``cuda``:

* ``prof_laneops``: the probes P1-P4 (dynamic lane-offset reads and writes
  in shared memory), the port of ``scripts/prof_laneops.py``;
* ``prof_dma``: the probes P5 and P6 (the gather and the read-modify-write
  of runs of pool rows) beside torch indexing and ``index_add_``, the port
  of ``scripts/prof_dma.py``;
* ``prof_stages25m``: ``MPMEngine.profile_stages`` on the 25M-particle
  sphere and the transfer's particle-stream floor, the port of
  ``scripts/prof_stages25m.py``;
* ``prof_rebuild``: the full rebuild's key sort, tile plan and table
  rebuild on the 1M-particle cube, the port of ``scripts/prof_rebuild.py``.
"""
