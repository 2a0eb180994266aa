"""LM serving: prefill and decode step builders and a generate loop."""
