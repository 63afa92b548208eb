"""Data: synthetic generator, splits and the eval-time transform."""
