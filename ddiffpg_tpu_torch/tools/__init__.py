"""Tools of the port: the checkpoint and run readers of the root `tools/`
(`python -m ddiffpg_tpu_torch.tools.<name>`, on the card unless told
`device=cpu`), and measurement scripts run on a card."""
