"""Command-line tools of the port, run as modules:

    python -m fastdem_tpu_torch.tools.fastdem_node --preset local_mapping --synthetic 16 --out DIR
    python -m fastdem_tpu_torch.tools.fastdem_replay --preset local_mapping --synthetic 64 --batch 16
"""
