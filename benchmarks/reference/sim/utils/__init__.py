"""Host-side helpers of the layout generators."""
