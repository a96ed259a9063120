"""Serving engine of the port: detector rule, classify program, analyzer."""
