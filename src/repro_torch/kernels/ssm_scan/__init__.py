"""Selective scan (the Mamba recurrence): the plain version (`ref`) and the
kernel wrapper (`ops`)."""
