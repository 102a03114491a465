"""Session-pool serving over the event engine."""
