"""The port's walkthroughs (ports of the reference's ``examples/``), each run
as ``python -m repro_torch.examples.<name>``: on the card by default, on
the CPU with ``--device cpu``.

  quickstart        the table's semantics through the public handle
  dlrm_continuous   the paper's DLRM workload under online ingestion
  online_serving    the serving engine over a publisher and a trainer
  train_lm_hkv      an LM trained with the HKV embedding, with a restart
"""
