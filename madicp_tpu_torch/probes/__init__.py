"""Same-process A/B probes of kernel designs on the card, run as modules
(``python -m madicp_tpu_torch.probes.<name>``)."""
