"""Evaluation: the template A/B success-rate campaign (`campaign`), its
summary statistics (`analysis`) and its runner (`run_campaign_ab`); the
scenario-batched whole-body team's runner (`run_team`)."""
