"""The reference's examples on the port: ``quickstart`` (SASRec base
against RecJPQ-svd), ``serve_retrieval`` (RecJPQ two-tower serving),
``paper_validation`` (3 backbones x 5 item tables x 2 data profiles) and
``train_mace_molecule`` (MACE's energy regression on molecules).
Each runs as ``python -m repro_torch.examples.<name>`` on ``cuda``
unless given ``--device cpu``."""
