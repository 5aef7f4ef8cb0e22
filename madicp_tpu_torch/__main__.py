from madicp_tpu_torch.apps.cli import run

run()
