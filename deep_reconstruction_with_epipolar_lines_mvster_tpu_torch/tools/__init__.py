"""Measurement tools of the port: A/B timing, kernel variants, run-to-run
noise, the roofline, profile tables and the convergence demo."""
