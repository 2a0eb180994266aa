"""The reference's documented entry points, ported: one module for each
of its ``examples/`` scripts, each run as
``python -m repro_torch.examples.<name>``.

* ``quickstart``: decoder sessions, a strict skip, eligibility, the two
  protocols and the decision report;
* ``serve_decode``: the bandit-routed decode service under concurrent
  clients, with its ``/metrics`` endpoint;
* ``serve_lm``: batched LM generation (prefill, then decode);
* ``storage_loader``: ingest to shards, a forked loader, a mid-epoch
  checkpoint and an exact resume;
* ``autotune_workers``: the loader's worker-count sweep.

The sixth example, ``train_vision_pipeline.py``, has its counterpart in
``repro_torch.train.vision_pipeline``.

Each module's ``main(argv=None)`` takes the reference's flags plus
``--device`` and returns what it printed as a dict. It runs on the card
unless ``--device cpu`` is given; without a card it exits 2 and never
carries on on the CPU.
"""
