"""Event sources for the AER serving path."""
