"""Training: the scan trainer, its optimizer, data pipeline and loop."""
