"""Checkpoint reading and the weight carry-over from satae."""
