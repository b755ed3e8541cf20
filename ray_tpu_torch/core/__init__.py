"""Core runtime: ids, resources, scheduling, object store, tasks, actors."""
