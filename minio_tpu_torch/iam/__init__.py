"""Identities and policies: IAMSys, the policy engine and STS."""
