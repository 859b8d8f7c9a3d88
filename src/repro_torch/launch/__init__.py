"""Launchers (the reference's ``launch``; its mesh and dry-run tools wait
for the multi-device path)."""
