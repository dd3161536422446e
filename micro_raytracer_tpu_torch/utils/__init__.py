"""Asset loaders, device choice, kernel builds, profiling."""
