"""Workload traces of the port: Mooncake-statistics synthetic generator + profiles
(a copy of ``repro.traces``)."""

from .mooncake import PROFILES, Profile, Request, calibrated_capacity_rps, empirical_means, generate_trace, profile_capacity

__all__ = ["PROFILES", "Profile", "Request", "calibrated_capacity_rps", "empirical_means", "generate_trace", "profile_capacity"]
