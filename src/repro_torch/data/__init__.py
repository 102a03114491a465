"""Token sources for training and event sources for the AER serving path."""
