"""Trainer and learning-rate schedules."""
