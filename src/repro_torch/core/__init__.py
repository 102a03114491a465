"""Routing compiler, two-stage dispatch, neuron dynamics and the event engine."""
