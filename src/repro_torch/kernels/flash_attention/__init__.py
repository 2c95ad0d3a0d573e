"""Flash attention: plain version (`ref`) and kernel wrapper (`ops`)."""
