"""The general harness: what every cell shares (the yardstick)."""
