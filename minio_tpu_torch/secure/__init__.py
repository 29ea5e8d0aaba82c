"""Secrets at rest: the sealing of config.json and iam.json."""
